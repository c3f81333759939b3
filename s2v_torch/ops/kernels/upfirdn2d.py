"""upfirdn2d: zero-stuff by ``up``, pad (a negative pad crops), convolve with
a FIR of at most 4x4 taps, keep every ``down``-th sample, on both spatial
axes of an NCHW tensor.

The StyleGAN2 resampling primitive behind GPEN's Blur, Upsample and encoder
downsample. On a CUDA tensor the wrapper launches the hand-written kernel K3
``s2v_torch/csrc/upfirdn2d.cu`` (the port of
``s2v_tpu/ops/pallas/upfirdn2d.py::upfirdn2d_pallas``), which covers every
width with no fallback; on a CPU tensor it runs the plain PyTorch version
below (stuff, pad, depthwise ``F.conv2d`` with the flipped FIR).

``upfirdn2d`` is a ``torch.autograd.Function``. Its gradient is another
upfirdn2d (GPEN's ``UpFirDn2dBackward``): the flipped FIR, ``up`` and
``down`` swapped, per axis a leading pad of ``k - p0 - 1`` and a trailing pad
that gives back the input's size. The backward calls the Function itself, so
the double backward (R1) is K3 again with the original parameters. Backward
launches count on K3's counter (``kernel.launch.upfirdn2d``).

K3 is the operator ``s2v::upfirdn2d`` (``_ops.py``): its CUDA
implementation launches the kernel, its CPU implementation runs the plain
version, and its fake implementation gives the output's shape, so
``torch.export`` keeps it in its graph. The FIR travels as its taps in row
order with its height and width.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2v_torch.ops.kernels import _build, _ops
from s2v_torch.ops.kernels.fused_act import _on_a_device
from s2v_torch.utils import trace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Pad = Tuple[int, int]


def out_size(size: int, k: int, up: int, down: int, pad: Pad) -> int:
    return (size * up + pad[0] + pad[1] - k) // down + 1


def grad_pad(size: int, out: int, k: int, up: int, down: int, pad: Pad) -> Pad:
    """Per-axis pads of the upfirdn2d that is the gradient of one with these
    parameters (input ``size``, output ``out``): its output is ``size``."""
    return k - pad[0] - 1, size * up - out * down + pad[0] - up + 1


def stuff_and_pad(x: torch.Tensor, up: int, pad: Pad,
                  pad_x: Optional[Pad] = None) -> torch.Tensor:
    """Insert (up-1) zeros after every sample and pad the rows by ``pad`` and
    the columns by ``pad_x`` (``pad`` when None); negative entries crop."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.view(b, c, h * up, w * up)
    (y0, y1), (x0, x1) = pad, pad if pad_x is None else pad_x
    x = F.pad(x, [max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)])
    return x[:, :, max(-y0, 0):x.shape[2] - max(-y1, 0),
             max(-x0, 0):x.shape[3] - max(-x1, 0)]


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                    pad: Pad = (0, 0), pad_x: Optional[Pad] = None) -> torch.Tensor:
    """Plain PyTorch version: stuff, pad (``pad`` on the rows, ``pad_x`` on
    the columns, ``pad`` on both when None), then a depthwise correlation
    with the flipped FIR (a convolution with ``kernel``), stride ``down``."""
    c = x.shape[1]
    # a copy: a flipped 1x1 FIR keeps its negative strides through
    # np.ascontiguousarray, and torch refuses those
    k = torch.as_tensor(np.array(kernel, np.float32), device=x.device)
    w = torch.flip(k, (0, 1)).to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(stuff_and_pad(x, up, pad, pad_x), w, stride=down, groups=c)


_kernel = None


def _launcher():
    global _kernel
    if _kernel is None:
        fn = _build.load("upfirdn2d").s2v_upfirdn2d
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        fn.argtypes += [ctypes.c_int] * 10
        fn.argtypes += [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                        ctypes.c_void_p]
        _kernel = fn
    return _kernel


def _out_shape(x: torch.Tensor, kh: int, kw: int, up: int, down: int, py0: int, py1: int,
               px0: int, px1: int) -> tuple:
    b, c, h, w = x.shape
    return (b, c, out_size(h, kh, up, down, (py0, py1)), out_size(w, kw, up, down, (px0, px1)))


def _cuda(x: torch.Tensor, fir: list, kh: int, kw: int, up: int, down: int, py0: int,
          py1: int, px0: int, px1: int) -> torch.Tensor:
    """K3's launch: the CUDA implementation of ``s2v::upfirdn2d``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"upfirdn2d: dtype {x.dtype} not supported")
    if x.dim() != 4 or max(kh, kw) > 4:
        raise ValueError(f"upfirdn2d: x {tuple(x.shape)} must be NCHW and the "
                         f"FIR at most 4x4, got {(kh, kw)}")
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up={up}, down={down} must be >= 1")
    shape = _out_shape(x, kh, kw, up, down, py0, py1, px0, px1)
    if shape[2] < 1 or shape[3] < 1:
        raise ValueError(f"upfirdn2d: empty output {shape[2]}x{shape[3]}")
    x = x.contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    # the kernel correlates: it takes the flipped FIR
    taps = (ctypes.c_float * (kh * kw))(*fir[::-1])
    rc = _launcher()(x.data_ptr(), out.data_ptr(), shape[0] * shape[1], x.shape[2], x.shape[3],
                     shape[2], shape[3], up, down, py0, px0, kh, kw, taps, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upfirdn2d: CUDA launch error {rc}")
    trace.count("kernel.launch.upfirdn2d")
    return out


def _cpu(x, fir, kh, kw, up, down, py0, py1, px0, px1):
    with torch.no_grad():  # records no graph, as the kernel records none
        return upfirdn2d_plain(x, np.reshape(fir, (kh, kw)), up, down, (py0, py1), (px0, px1))


def _fake(x, fir, kh, kw, up, down, py0, py1, px0, px1):
    return x.new_empty(_out_shape(x, kh, kw, up, down, py0, py1, px0, px1))


_OP = _ops.define(
    "upfirdn2d(Tensor x, float[] fir, int kh, int kw, int up, int down, int pad_y0, "
    "int pad_y1, int pad_x0, int pad_x1) -> Tensor", _cuda, _cpu, _fake)


def upfirdn2d_fwd(x: torch.Tensor, kernel, up: int, down: int, pad_y: Pad,
                  pad_x: Pad) -> torch.Tensor:
    """K3 (no autograd) with its own pads per axis: x [B, C, H, W] f32 or
    bf16; kernel [kh, kw] FIR, kh, kw <= 4. Accumulates in f32; returns x's
    dtype."""
    _on_a_device("upfirdn2d", x)
    k = np.asarray(kernel, np.float32)
    if k.ndim != 2:
        raise ValueError(f"upfirdn2d: the FIR must be 2-D, got {k.shape}")
    return _OP(x, k.ravel().tolist(), k.shape[0], k.shape[1], up, down, *pad_y, *pad_x)


class UpFirDn2d(torch.autograd.Function):
    """K3 forward; the backward is this Function again with the gradient's
    parameters, so every order of derivative runs K3 (and none runs on a
    missing gradient)."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad_y, pad_x):
        out = upfirdn2d_fwd(x, kernel, up, down, pad_y, pad_x)
        kh, kw = kernel.shape
        ctx.grad_args = (np.ascontiguousarray(kernel[::-1, ::-1]), down, up,
                         grad_pad(x.shape[2], out.shape[2], kh, up, down, pad_y),
                         grad_pad(x.shape[3], out.shape[3], kw, up, down, pad_x))
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g):
        dx = None if g is None else UpFirDn2d.apply(g, *ctx.grad_args)
        return dx, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Pad = (0, 0)) -> torch.Tensor:
    """x: [B, C, H, W] f32 or bf16 (any float dtype on the CPU); kernel:
    [kh, kw] FIR (numpy or list), kh, kw <= 4; ``pad`` on both axes.
    Differentiable to any order in x."""
    k = np.asarray(kernel, np.float32)
    return UpFirDn2d.apply(x, k, up, down, tuple(pad), tuple(pad))

