"""Tensor ops of the port: plain torch einsum work and hand-written kernels."""
