"""Shared blocks of LNet and ENet (reference: models/base_blocks.py), NCHW.

Module and parameter names follow the reference's torch modules, so their
``state_dict`` keys match the reference checkpoints (spectral-normalised
convs load through ``s2v_torch.utils.weights.load_reference``, which folds
``weight_orig / sigma`` into ``weight``). Conditioning vectors ``z`` are
[B, F].

Reference quirks kept for checkpoint parity:
- LayerNorm2d normalises over (C, H, W) jointly with a per-channel affine.
- StyleConv's noise injection runs only in its zero-noise mode here (the
  inference configuration), so it contributes nothing and is skipped.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.ops.image import resize_bilinear, resize_nearest
from s2v_torch.ops.norms import instance_norm_2d, layer_norm_chw


class LayerNorm2d(nn.Module):
    """base_blocks.py LayerNorm2d: affine params of shape (C, 1, 1)."""

    def __init__(self, n_out: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_out, 1, 1))
        self.bias = nn.Parameter(torch.zeros(n_out, 1, 1))

    def forward(self, x):
        return layer_norm_chw(x, self.weight, self.bias, self.eps)


class ConvBNReLU(nn.Module):
    """base_blocks.py Conv2d (LNet's audio encoder block): conv + BN
    (+ residual) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=1,
                 residual: bool = False):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride, padding), nn.BatchNorm2d(cout))
        self.residual = residual

    def forward(self, x):
        out = self.conv_block(x)
        if self.residual:
            out = out + x
        return F.relu(out)


class AdaIN(nn.Module):
    """ADAIN (base_blocks.py:127-157): instance norm modulated by z."""

    def __init__(self, norm_nc: int, feature_nc: int, hidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.Linear(feature_nc, hidden), nn.ReLU())
        self.mlp_gamma = nn.Linear(hidden, norm_nc)
        self.mlp_beta = nn.Linear(hidden, norm_nc)

    def forward(self, x, z):
        h = self.mlp_shared(z)
        gamma = self.mlp_gamma(h)[:, :, None, None]
        beta = self.mlp_beta(h)[:, :, None, None]
        return instance_norm_2d(x) * (1.0 + gamma) + beta


class _NormBlock(nn.Module):
    """conv + LayerNorm2d + leaky ReLU as ``model``, the layout of the
    reference's FirstBlock2d / DownBlock2d / UpBlock2d / Jump."""

    def __init__(self, cin, cout, kernel, padding, slope, pool=False):
        super().__init__()
        layers = [nn.Conv2d(cin, cout, kernel, 1, padding), LayerNorm2d(cout),
                  nn.LeakyReLU(slope)]
        if pool:
            layers.append(nn.AvgPool2d(2))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def FirstBlock2d(cin, cout, slope=0.1):
    return _NormBlock(cin, cout, 7, 3, slope)


def DownBlock2d(cin, cout, slope=0.1):
    return _NormBlock(cin, cout, 3, 1, slope, pool=True)


def Jump(cin, cout, slope=0.1):
    return _NormBlock(cin, cout, 3, 1, slope)


class UpBlock2d(_NormBlock):
    """Nearest x2 upsample, then conv + norm + leaky ReLU."""

    def __init__(self, cin, cout, slope=0.1):
        super().__init__(cin, cout, 3, 1, slope)

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.model(resize_nearest(x, (2 * h, 2 * w)))


class FinalBlock2d(nn.Module):
    def __init__(self, cin, cout, activation: str = "sigmoid"):
        super().__init__()
        act = nn.Sigmoid() if activation == "sigmoid" else nn.Tanh()
        self.model = nn.Sequential(nn.Conv2d(cin, cout, 7, 1, 3), act)

    def forward(self, x):
        return self.model(x)


class ResBlockENet(nn.Module):
    """StyleGAN2-style ResBlock with bilinear resample (base_blocks.py:29-49):
    mode 'down' halves the resolution, 'up' doubles it."""

    def __init__(self, cin: int, cout: int, mode: str = "down"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1)
        self.conv2 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.skip = nn.Conv2d(cin, cout, 1, bias=False)
        self.mode = mode

    def forward(self, x):
        h, w = x.shape[-2:]
        out_hw = (h // 2, w // 2) if self.mode == "down" else (2 * h, 2 * w)
        out = F.leaky_relu(self.conv1(x), 0.2)
        out = F.leaky_relu(self.conv2(resize_bilinear(out, out_hw)), 0.2)
        return out + self.skip(resize_bilinear(x, out_hw))


class ModulatedConv2d(nn.Module):
    """StyleGAN2 modulated conv (base_blocks.py:460-508).

    Modulation folds into an input-channel scale and demodulation into an
    output-channel scale around one shared conv (algebraically the
    reference's grouped conv). The scale is applied on the smaller side of
    the bilinear resample, which it commutes with.
    """

    def __init__(self, cin: int, cout: int, kernel: int, num_style_feat: int,
                 demodulate: bool = True, sample_mode: Optional[str] = None,
                 eps: float = 1e-8):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(1, cout, cin, kernel, kernel) / math.sqrt(cin * kernel ** 2))
        self.modulation = nn.Linear(num_style_feat, cin)
        nn.init.normal_(self.modulation.weight, std=num_style_feat ** -0.5)
        nn.init.ones_(self.modulation.bias)
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.eps = eps
        self.padding = kernel // 2

    def forward(self, x, style):
        b = x.shape[0]
        h, w = x.shape[-2:]
        s = self.modulation(style.reshape(b, -1))  # [B, Cin]
        sc = s[:, :, None, None].to(x.dtype)
        if self.sample_mode == "upsample":
            x = resize_bilinear(x * sc, (2 * h, 2 * w))
        elif self.sample_mode == "downsample":
            x = resize_bilinear(x, (h // 2, w // 2)) * sc
        else:
            x = x * sc
        weight = self.weight[0]
        out = F.conv2d(x, weight.to(x.dtype), padding=self.padding)
        if self.demodulate:
            w2 = weight.float().square().sum(dim=(2, 3))  # [Cout, Cin]
            demod = torch.rsqrt(s.float().square() @ w2.t() + self.eps)
            out = out * demod[:, :, None, None].to(out.dtype)
        return out


class StyleConv(nn.Module):
    """base_blocks.py:515-536: modconv * sqrt(2) + bias, leaky ReLU 0.2.
    ``weight`` is the noise-injection strength; the port runs the zero-noise
    mode, where the injection adds nothing."""

    def __init__(self, cin, cout, kernel, num_style_feat, demodulate=True,
                 sample_mode=None):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(cin, cout, kernel, num_style_feat,
                                              demodulate, sample_mode)
        self.weight = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style):
        out = self.modulated_conv(x, style) * (2.0 ** 0.5)
        return F.leaky_relu(out + self.bias.to(out.dtype), 0.2)


class ToRGB(nn.Module):
    """base_blocks.py:539-554."""

    def __init__(self, cin, num_style_feat, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv2d(cin, 3, 1, num_style_feat,
                                              demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            if self.upsample:
                h, w = skip.shape[-2:]
                skip = resize_bilinear(skip, (2 * h, 2 * w))
            out = out + skip
        return out
