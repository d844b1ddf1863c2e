"""Tensor ops of the port: convolutions, resampling and the CUDA kernel wrappers."""
