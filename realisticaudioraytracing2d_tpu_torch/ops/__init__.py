"""Tensor operations: geometry, random numbers, trace, IR, convolution."""
