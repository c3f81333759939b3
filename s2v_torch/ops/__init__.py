"""Tensor primitives of the port (NCHW), and its CUDA kernels under
``s2v_torch.ops.kernels``."""
