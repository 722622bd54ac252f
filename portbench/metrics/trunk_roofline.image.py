"""trunk_roofline.image: the trunk's least time over its kernels' time."""

from portbench.readers import trunk_roofline as read  # noqa: F401
