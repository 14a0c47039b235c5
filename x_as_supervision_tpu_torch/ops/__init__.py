"""Tensor ops of the port and the bindings of its CUDA kernels."""
