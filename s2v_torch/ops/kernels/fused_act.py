"""Fused bias + scaled LeakyReLU: ``scale * leaky_relu(x + bias[c], 0.2)``,
forward and backward.

The StyleGAN2 activation used throughout GPEN (EqualLinear with
``fused_lrelu``, StyledConv, ConvLayer). Two hand-written kernels in
``s2v_torch/csrc/fused_act.cu`` carry it on the card, the ports of
``s2v_tpu/ops/pallas/fused_act.py``'s two Pallas kernels:

- K1 ``fused_bias_leaky_relu_fwd``: the forward;
- K2 ``fused_bias_leaky_relu_bwd``: ``dx = (g + b[c]) * (out >= 0 ? scale :
  scale * slope)`` from the saved output's sign. Without ``b`` it is the
  backward; with ``b`` the gradient of the backward, which R1's double
  backward needs.

``fused_bias_leaky_relu`` is the entry point the models call: a
``torch.autograd.Function`` whose forward is K1, whose backward is a second
Function (K2 plus the ``dbias`` reduction, left to PyTorch as the JAX package
leaves it to XLA), and whose double backward is K2 with the incoming
``dbias`` gradient as ``b``. Each kernel is an operator of the ``s2v``
namespace (``s2v::fused_act_fwd``, ``s2v::fused_act_bwd``; ``_ops.py``):
its CUDA implementation launches the kernel, its CPU implementation runs
the plain PyTorch version, and neither records an autograd graph, so the
CPU tests exercise the Functions' wiring and ``torch.export`` keeps the
operators in its graph. Layout is channels at dim 1 (NCHW, or
``[B, C]`` for linear outputs).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from s2v_torch.ops.kernels import _build, _ops
from s2v_torch.utils import trace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _channel_view(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return v.to(ref.dtype).view(1, -1, *([1] * (ref.dim() - 2)))


def fused_bias_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                                negative_slope: float = 0.2,
                                scale: float = 2 ** 0.5) -> torch.Tensor:
    """Plain PyTorch version of K1: bias add, where, scale."""
    y = x + _channel_view(bias, x)
    return scale * torch.where(y >= 0, y, y * negative_slope)


def fused_bias_leaky_relu_bwd_plain(g: torch.Tensor, out: torch.Tensor,
                                    bias: Optional[torch.Tensor] = None,
                                    negative_slope: float = 0.2,
                                    scale: float = 2 ** 0.5) -> torch.Tensor:
    """Plain PyTorch version of K2: ``(g + bias[c])`` times ``scale`` where
    ``out >= 0`` and ``scale * negative_slope`` elsewhere."""
    if bias is not None:
        g = g + _channel_view(bias, g)
    return torch.where(out >= 0, g * scale, g * (scale * negative_slope))


_kernels = {}


def _launcher(name: str, argtypes):
    fn = _kernels.get(name)
    if fn is None:
        fn = getattr(_build.load("fused_act"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _kernels[name] = fn
    return fn


def _on_a_device(name: str, x: torch.Tensor) -> None:
    """The operators have a CUDA and a CPU implementation and nothing else
    (a meta tensor would reach the fake one)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def _check(name: str, x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() < 2 or (bias is not None and bias.shape != (x.shape[1],)):
        raise ValueError(f"{name}: x {tuple(x.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} "
                         "do not match on dim 1")


def _f32_bias(bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return bias.detach().to(device=x.device, dtype=torch.float32).contiguous()


def _fwd_cuda(x: torch.Tensor, bias: torch.Tensor, negative_slope: float,
              scale: float) -> torch.Tensor:
    """K1's launch: the CUDA implementation of ``s2v::fused_act_fwd``."""
    _check("fused_bias_leaky_relu", x, bias)
    x = x.contiguous()
    b = _f32_bias(bias, x)
    out = torch.empty_like(x)
    fn = _launcher("s2v_fused_bias_lrelu",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), b.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            math.prod(x.shape[2:]), _DTYPES[x.dtype], negative_slope, scale,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bias_leaky_relu: CUDA launch error {rc}")
    trace.count("kernel.launch.fused_act")
    return out


def _fwd_cpu(x, bias, negative_slope, scale):
    with torch.no_grad():  # records no graph, as the kernel records none
        return fused_bias_leaky_relu_plain(x, bias, negative_slope, scale)


def _bwd_cuda(g: torch.Tensor, out: torch.Tensor, bias: Optional[torch.Tensor],
              negative_slope: float, scale: float) -> torch.Tensor:
    """K2's launch: the CUDA implementation of ``s2v::fused_act_bwd``."""
    _check("fused_bias_leaky_relu_bwd", g, bias)
    if out.shape != g.shape or out.dtype != g.dtype or out.device != g.device:
        raise ValueError(f"fused_bias_leaky_relu_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"and out {tuple(out.shape)} {out.dtype} differ")
    g, out = g.contiguous(), out.contiguous()
    b = None if bias is None else _f32_bias(bias, g)
    dx = torch.empty_like(g)
    fn = _launcher("s2v_fused_lrelu_bwd",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p])
    rc = fn(g.data_ptr(), out.data_ptr(), None if b is None else b.data_ptr(),
            dx.data_ptr(), g.shape[0], g.shape[1], math.prod(g.shape[2:]),
            _DTYPES[g.dtype], scale, scale * negative_slope,
            torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bias_leaky_relu_bwd: CUDA launch error {rc}")
    trace.count("kernel.launch.fused_act_bwd")
    return dx


def _bwd_cpu(g, out, bias, negative_slope, scale):
    with torch.no_grad():
        return fused_bias_leaky_relu_bwd_plain(g, out, bias, negative_slope, scale)


def _like(x: torch.Tensor, *_) -> torch.Tensor:
    """The operators' fake implementation: a contiguous tensor like x."""
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_FWD = _ops.define(
    "fused_act_fwd(Tensor x, Tensor bias, float negative_slope, float scale) -> Tensor",
    _fwd_cuda, _fwd_cpu, _like)
_BWD = _ops.define(
    "fused_act_bwd(Tensor g, Tensor out, Tensor? bias, float negative_slope, float scale)"
    " -> Tensor",
    _bwd_cuda, _bwd_cpu, _like)


def fused_bias_leaky_relu_fwd(x: torch.Tensor, bias: torch.Tensor,
                              negative_slope: float = 0.2,
                              scale: float = 2 ** 0.5) -> torch.Tensor:
    """K1 (no autograd): x [B, C, ...] f32 or bf16; bias [C]. Returns a
    tensor like x."""
    _on_a_device("fused_bias_leaky_relu", x)
    return _FWD(x, bias, float(negative_slope), float(scale))


def fused_bias_leaky_relu_bwd(g: torch.Tensor, out: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              negative_slope: float = 0.2,
                              scale: float = 2 ** 0.5) -> torch.Tensor:
    """K2 (no autograd): g and out [B, C, ...] of one dtype (f32 or bf16) and
    shape; bias None or [C]. Returns dx like g."""
    _on_a_device("fused_bias_leaky_relu_bwd", g)
    return _BWD(g, out, bias, float(negative_slope), float(scale))


class FusedActBackward(torch.autograd.Function):
    """(g, out) -> (dx, dbias): K2, then ``dbias = dx`` summed over every
    axis but dim 1, in f32 (f64 for f64 input). Its own backward is K2 with
    the incoming ``dbias`` gradient as ``b``; ``out`` gets no gradient (the
    activation's slope is constant almost everywhere)."""

    @staticmethod
    def forward(ctx, g, out, negative_slope, scale):
        ctx.save_for_backward(out)
        ctx.slope, ctx.scale = negative_slope, scale
        ctx.set_materialize_grads(False)
        dx = fused_bias_leaky_relu_bwd(g, out, None, negative_slope, scale)
        dims = [0] + list(range(2, dx.dim()))
        return dx, dx.sum(dim=dims, dtype=torch.promote_types(dx.dtype, torch.float32))

    @staticmethod
    @once_differentiable
    def backward(ctx, gg_dx, gg_dbias):
        if gg_dx is None and gg_dbias is None:
            return None, None, None, None
        (out,) = ctx.saved_tensors
        if gg_dx is None:
            gg_dx = torch.zeros_like(out)
        return (fused_bias_leaky_relu_bwd(gg_dx, out, gg_dbias, ctx.slope, ctx.scale),
                None, None, None)


class FusedAct(torch.autograd.Function):
    """K1 forward, saving its output; backward through FusedActBackward, so
    the gradient is itself differentiable. A backward reached with no
    gradient (as R1's double backward reaches the layers after the
    minibatch-stddev input) launches nothing."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = fused_bias_leaky_relu_fwd(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.slope, ctx.scale = negative_slope, scale
        ctx.bias_dtype = bias.dtype
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g):
        if g is None:  # reached with no gradient (R1's double backward): no launch
            return None, None, None, None
        (out,) = ctx.saved_tensors
        dx, dbias = FusedActBackward.apply(g, out, ctx.slope, ctx.scale)
        return (dx if ctx.needs_input_grad[0] else None,
                dbias.to(ctx.bias_dtype) if ctx.needs_input_grad[1] else None,
                None, None)


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                          negative_slope: float = 0.2,
                          scale: float = 2 ** 0.5) -> torch.Tensor:
    """x: [B, C, ...] f32 or bf16 (any float dtype on the CPU); bias: [C].
    Returns a tensor like x, differentiable twice in x and bias."""
    return FusedAct.apply(x, bias, negative_slope, scale)

