"""Tensor functions and hand-written kernels of the port."""
