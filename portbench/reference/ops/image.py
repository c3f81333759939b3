"""Frame layout, image resampling and padding on NCHW tensors.

s2v_tpu/ops/image.py rebuilds ``F.interpolate``'s conventions (half-pixel
centres, no antialias, legacy nearest) as interpolation matmuls for the TPU;
here they are PyTorch's own operators, which define those conventions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def frames_to_nchw(frames, device) -> torch.Tensor:
    """NHWC uint8 frames (numpy or tensor) -> NCHW float32 on ``device``,
    values 0..255."""
    return torch.as_tensor(frames, device=device).permute(0, 3, 1, 2).float()


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)``; identity when
    the size already matches."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` (legacy index math)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(2)`` (FAN's hourglass and stem)."""
    return F.avg_pool2d(x, 2)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``F.pad(mode='reflect')`` on both spatial axes (REFLECT_101)."""
    return F.pad(x, [pad, pad, pad, pad], mode="reflect")
