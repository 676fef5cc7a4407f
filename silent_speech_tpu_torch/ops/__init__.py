"""Numerical building blocks and the CUDA kernels with their plain versions."""
