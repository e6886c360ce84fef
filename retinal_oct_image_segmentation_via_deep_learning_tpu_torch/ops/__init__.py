"""Kernels of the serving path (CUDA, with plain PyTorch versions)."""
