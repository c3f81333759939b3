"""upfirdn2d: zero-stuff by ``up``, pad (a negative pad crops), convolve with
a FIR of at most 4x4 taps, keep every ``down``-th sample, on both spatial
axes of an NCHW tensor.

The StyleGAN2 resampling primitive behind GPEN's Blur, Upsample and encoder
downsample. On a CUDA tensor the wrapper launches the hand-written kernel
``s2v_torch/csrc/upfirdn2d.cu`` (the port of
``s2v_tpu/ops/pallas/upfirdn2d.py::upfirdn2d_pallas``), which covers every
width with no fallback; on a CPU tensor it runs the plain PyTorch version
below (stuff, pad, depthwise ``F.conv2d`` with the flipped FIR).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2v_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def out_size(size: int, k: int, up: int, down: int, pad: Tuple[int, int]) -> int:
    return (size * up + pad[0] + pad[1] - k) // down + 1


def stuff_and_pad(x: torch.Tensor, up: int, pad: Tuple[int, int]) -> torch.Tensor:
    """Insert (up-1) zeros after every sample and pad both spatial axes by
    ``pad`` (negative entries crop)."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.view(b, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    if p0 < 0 or p1 < 0:
        s0, s1 = max(-p0, 0), max(-p1, 0)
        x = x[:, :, s0:x.shape[2] - s1, s0:x.shape[3] - s1]
    return x


def upfirdn2d_plain(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
                    pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version: stuff, pad, then a depthwise correlation with
    the flipped FIR (a convolution with ``kernel``), stride ``down``."""
    c = x.shape[1]
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    w = torch.flip(k, (0, 1)).to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(stuff_and_pad(x, up, pad), w, stride=down, groups=c)


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


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x: [B, C, H, W] f32 or bf16; kernel: [kh, kw] FIR (numpy or list),
    kh, kw <= 4. Accumulates in f32; returns x's dtype."""
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, kernel, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"upfirdn2d: dtype {x.dtype} not supported")
    k = np.ascontiguousarray(np.asarray(kernel, np.float32)[::-1, ::-1])
    if x.dim() != 4 or k.ndim != 2 or max(k.shape) > 4:
        raise ValueError(f"upfirdn2d: x {tuple(x.shape)} must be NCHW and the "
                         f"FIR at most 4x4, got {k.shape}")
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up={up}, down={down} must be >= 1")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("upfirdn2d: no backward kernel")
    b, c, h, w = x.shape
    kh, kw = k.shape
    oh = out_size(h, kh, up, down, pad)
    ow = out_size(w, kw, up, down, pad)
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: empty output {oh}x{ow}")
    x = x.contiguous()
    out = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device)
    taps = (ctypes.c_float * k.size)(*k.ravel().tolist())
    rc = _launcher()(x.data_ptr(), out.data_ptr(), b * c, h, w, oh, ow, up,
                     down, pad[0], pad[0], kh, kw, taps, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upfirdn2d: CUDA launch error {rc}")
    upfirdn2d.launches += 1
    return out


upfirdn2d.launches = 0
