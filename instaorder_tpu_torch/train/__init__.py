"""Training (counterpart of instaorder_tpu/train)."""
