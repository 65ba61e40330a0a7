"""Tensor operations of the port: bitsets, ELL propagation, masked
scoring (the hand-written CUDA kernel) and top-k."""
