"""Normalisations with the reference's conventions, statistics in f32.

- ``layer_norm_chw``: the reference's LayerNorm2d normalises each sample
  over (C, H, W) jointly, then applies a per-channel affine.
- ``instance_norm_2d``: ``nn.InstanceNorm2d(affine=False)``, batch
  statistics per (sample, channel).

Statistics accumulate in f32 whatever the input dtype: a bf16 mean over
384*384*C elements loses about three digits.
"""

from __future__ import annotations

import torch


def layer_norm_chw(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x: [B, C, H, W]; weight, bias: [C, 1, 1]."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = xf.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [B, C, H, W], normalised per (sample, channel) over H, W."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
