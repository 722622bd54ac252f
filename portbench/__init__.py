"""The benchmark of the PyTorch / CUDA port (instaorder_tpu_torch)."""
