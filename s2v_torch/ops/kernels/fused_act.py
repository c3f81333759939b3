"""Fused bias + scaled LeakyReLU: ``scale * leaky_relu(x + bias[c], 0.2)``.

The StyleGAN2 activation used throughout GPEN (EqualLinear with
``fused_lrelu``, StyledConv, ConvLayer). On a CUDA tensor the wrapper
launches the hand-written kernel ``s2v_torch/csrc/fused_act.cu`` (the port
of ``s2v_tpu/ops/pallas/fused_act.py``'s forward kernel); on a CPU tensor it
runs the plain PyTorch version below. Layout is channels at dim 1 (NCHW, or
``[B, C]`` for linear outputs).

Only the forward pass is ported; the backward kernel (training only) is
still to be ported, so the CUDA path refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from s2v_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_bias_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                                negative_slope: float = 0.2,
                                scale: float = 2 ** 0.5) -> torch.Tensor:
    """Plain PyTorch version: bias add, where, scale."""
    y = x + bias.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
    return scale * torch.where(y >= 0, y, y * negative_slope)


_kernel = None


def _launcher():
    global _kernel
    if _kernel is None:
        fn = _build.load("fused_act").s2v_fused_bias_lrelu
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        _kernel = fn
    return _kernel


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                          negative_slope: float = 0.2,
                          scale: float = 2 ** 0.5) -> torch.Tensor:
    """x: [B, C, ...] f32 or bf16; bias: [C]. Returns a tensor like x."""
    if x.device.type == "cpu":
        return fused_bias_leaky_relu_plain(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bias_leaky_relu: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_bias_leaky_relu: dtype {x.dtype} not supported")
    if x.dim() < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"fused_bias_leaky_relu: x {tuple(x.shape)} and bias "
                         f"{tuple(bias.shape)} do not match on dim 1")
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        raise NotImplementedError(
            "fused_bias_leaky_relu: the backward kernel is not ported yet")
    x = x.contiguous()
    b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    rc = _launcher()(x.data_ptr(), b.data_ptr(), out.data_ptr(), x.shape[0],
                     x.shape[1], math.prod(x.shape[2:]), _DTYPES[x.dtype],
                     float(negative_slope), float(scale),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bias_leaky_relu: CUDA launch error {rc}")
    fused_bias_leaky_relu.launches += 1
    return out


fused_bias_leaky_relu.launches = 0
