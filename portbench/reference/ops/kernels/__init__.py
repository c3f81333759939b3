"""The plain PyTorch versions of the port's hand-written kernels K1-K3
(``fused_bias_leaky_relu``, its backward, ``upfirdn2d``), under the names
the model files import. Autograd differentiates them to any order, so R1's
double backward needs no hand-written backward here."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Pad = Tuple[int, int]


def _channel_view(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return v.to(ref.dtype).view(1, -1, *([1] * (ref.dim() - 2)))


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                          negative_slope: float = 0.2,
                          scale: float = 2 ** 0.5) -> torch.Tensor:
    """K1's arithmetic: bias add, where, scale."""
    y = x + _channel_view(bias, x)
    return scale * torch.where(y >= 0, y, y * negative_slope)


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


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Pad = (0, 0)) -> torch.Tensor:
    """K3's arithmetic: stuff, pad, then a depthwise correlation with the
    flipped FIR (a convolution with ``kernel``), stride ``down``."""
    c = x.shape[1]
    k = torch.as_tensor(np.array(kernel, np.float32), device=x.device)
    w = torch.flip(k, (0, 1)).to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(stuff_and_pad(x, up, pad), w, stride=down, groups=c)
