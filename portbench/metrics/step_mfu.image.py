"""step_mfu.image: the useful FLOPs of the window over the chips' peak."""

from portbench.readers import step_mfu as read  # noqa: F401
