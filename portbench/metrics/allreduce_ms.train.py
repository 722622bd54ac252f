"""allreduce_ms.train: NCCL all-reduce device ms a step, without the
ranks' waits for each other (each collective's shortest rank)."""

from portbench.readers import allreduce_ms as read  # noqa: F401
