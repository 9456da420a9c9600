"""Tensor ops of the port: plain PyTorch functions and the CUDA kernels'
wrappers."""
