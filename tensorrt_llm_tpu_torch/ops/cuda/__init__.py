"""Hand-written CUDA kernels (csrc/*.cu) and their PyTorch wrappers."""
