"""Tensor primitives (NCHW) and the plain versions of K1-K3 (``ops.kernels``)."""
