"""trunk_roofline.offline: the trunk's least time over its kernels' time."""

from portbench.readers import trunk_roofline as read  # noqa: F401
