"""Hand-written GPU kernels and their PyTorch wrappers."""
