"""pad_share.image: padded pairs over the pairs the trunk received."""

from portbench.readers import pad_share as read  # noqa: F401
