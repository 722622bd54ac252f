"""idle_share.train: the traced stretch's share with the device idle."""

from portbench.readers import idle_share as read  # noqa: F401
