"""Shared blocks of LNet, ENet and DNet (reference: models/base_blocks.py),
NCHW.

Module and parameter names follow the reference's torch modules, so their
``state_dict`` keys match the reference checkpoints (spectral-normalised
convs load through ``portbench.reference.utils.weights.load_reference``, which folds
``weight_orig / sigma`` into ``weight``). Conditioning vectors ``z`` are
[B, F].

Reference quirks kept for checkpoint parity:
- LayerNorm2d normalises over (C, H, W) jointly with a per-channel affine.
- StyleConv's noise injection runs only in its zero-noise mode here (the
  inference configuration), so it contributes nothing and is skipped.
- FineADAINResBlock2d's first branch (conv1, norm1) is overwritten before
  use in the reference (base_blocks.py:173-177); its parameters stay so
  checkpoints load, and the branch is not computed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.ops.image import resize_bilinear, resize_nearest
from portbench.reference.ops.norms import instance_norm_2d, layer_norm_chw


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


class FineADAINResBlock2d(nn.Module):
    """base_blocks.py:160-177: out = norm2(conv2(x), z) + x. conv1 and norm1
    are loaded and never run (the reference overwrites their result)."""

    def __init__(self, features: int, feature_nc: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        self.norm1 = AdaIN(features, feature_nc)
        self.norm2 = AdaIN(features, feature_nc)

    def forward(self, x, z):
        return self.norm2(self.conv2(x), z) + x


class FineADAINResBlocks(nn.Module):
    def __init__(self, num_block: int, features: int, feature_nc: int):
        super().__init__()
        self.num_block = num_block
        for i in range(num_block):
            setattr(self, f"res{i}", FineADAINResBlock2d(features, feature_nc))

    def forward(self, x, z):
        for i in range(self.num_block):
            x = getattr(self, f"res{i}")(x, z)
        return x


class FineEncoder(nn.Module):
    """base_blocks.py:255-275: FirstBlock2d, then ``layers`` DownBlock2d;
    returns every level's features."""

    def __init__(self, image_nc: int, ngf: int, img_f: int, layers: int):
        super().__init__()
        self.layers = layers
        self.first = FirstBlock2d(image_nc, ngf)
        for i in range(layers):
            setattr(self, f"down{i}", DownBlock2d(min(ngf * 2 ** i, img_f),
                                                  min(ngf * 2 ** (i + 1), img_f)))

    def forward(self, x):
        out = [self.first(x)]
        for i in range(self.layers):
            out.append(getattr(self, f"down{i}")(out[-1]))
        return out


class FineDecoder(nn.Module):
    """base_blocks.py:278-305: per level, ADAIN residual blocks, an upsample
    block and a jump connection; tanh output."""

    def __init__(self, image_nc: int, feature_nc: int, ngf: int, img_f: int, layers: int,
                 num_block: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            cin, cout = min(ngf * 2 ** (i + 1), img_f), min(ngf * 2 ** i, img_f)
            setattr(self, f"res{i}", FineADAINResBlocks(num_block, cin, feature_nc))
            setattr(self, f"up{i}", UpBlock2d(cin, cout))
            setattr(self, f"jump{i}", Jump(cout, cout))
        self.final = FinalBlock2d(ngf, image_nc, "tanh")

    def forward(self, skips, z):
        skips = list(skips)
        out = skips.pop()
        for i in reversed(range(self.layers)):
            out = getattr(self, f"res{i}")(out, z)
            out = getattr(self, f"up{i}")(out)
            out = getattr(self, f"jump{i}")(skips.pop()) + out
        return self.final(out)


class ADAINEncoderBlock(nn.Module):
    """base_blocks.py:195-212: ADAIN -> leaky ReLU -> conv k4 s2, then
    ADAIN -> leaky ReLU -> conv k3."""

    def __init__(self, cin: int, cout: int, feature_nc: int, slope: float = 0.1):
        super().__init__()
        self.conv_0 = nn.Conv2d(cin, cout, 4, 2, 1)
        self.conv_1 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.norm_0 = AdaIN(cin, feature_nc)
        self.norm_1 = AdaIN(cout, feature_nc)
        self.slope = slope

    def forward(self, x, z):
        x = self.conv_0(F.leaky_relu(self.norm_0(x, z), self.slope))
        return self.conv_1(F.leaky_relu(self.norm_1(x, z), self.slope))


class ADAINDecoderBlock(nn.Module):
    """base_blocks.py:215-252 with transposed convs (k3 s2 p1 op1): a
    shortcut branch and a conv branch, both doubling the resolution."""

    def __init__(self, cin: int, cout: int, hidden: int, feature_nc: int,
                 slope: float = 0.1):
        super().__init__()
        self.conv_0 = nn.Conv2d(cin, hidden, 3, 1, 1)
        self.conv_1 = nn.ConvTranspose2d(hidden, cout, 3, 2, 1, 1)
        self.conv_s = nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1)
        self.norm_0 = AdaIN(cin, feature_nc)
        self.norm_1 = AdaIN(hidden, feature_nc)
        self.norm_s = AdaIN(cin, feature_nc)
        self.slope = slope

    def forward(self, x, z):
        x_s = self.conv_s(F.leaky_relu(self.norm_s(x, z), self.slope))
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, z), self.slope))
        return x_s + self.conv_1(F.leaky_relu(self.norm_1(dx, z), self.slope))


class ADAINEncoder(nn.Module):
    """base_blocks.py ADAINEncoder: a k7 input conv, then ``layers``
    ADAINEncoderBlocks; returns every level's features."""

    def __init__(self, image_nc: int, feature_nc: int, ngf: int, img_f: int, layers: int):
        super().__init__()
        self.layers = layers
        self.input_layer = nn.Conv2d(image_nc, ngf, 7, 1, 3)
        for i in range(layers):
            setattr(self, f"encoder{i}", ADAINEncoderBlock(
                min(ngf * 2 ** i, img_f), min(ngf * 2 ** (i + 1), img_f), feature_nc))

    def forward(self, x, z):
        out = [self.input_layer(x)]
        for i in range(self.layers):
            out.append(getattr(self, f"encoder{i}")(out[-1], z))
        return out


class ADAINDecoder(nn.Module):
    """base_blocks.py ADAINDecoder: the top ``decoder_layers`` levels, each
    concatenated with the encoder's skip of its resolution."""

    def __init__(self, feature_nc: int, ngf: int, img_f: int, encoder_layers: int,
                 decoder_layers: int):
        super().__init__()
        self.levels = range(encoder_layers - decoder_layers, encoder_layers)
        for i in self.levels:
            cin = min(ngf * 2 ** (i + 1), img_f) * (1 if i == encoder_layers - 1 else 2)
            cout = min(ngf * 2 ** i, img_f)
            setattr(self, f"decoder{i}", ADAINDecoderBlock(cin, cout, cout, feature_nc))
        self.output_nc = 2 * min(ngf * 2 ** self.levels[0], img_f)

    def forward(self, skips, z):
        skips = list(skips)
        out = skips.pop()
        for i in reversed(self.levels):
            out = torch.cat([getattr(self, f"decoder{i}")(out, z), skips.pop()], 1)
        return out


class ADAINHourglass(nn.Module):
    """base_blocks.py:308-365: the ADAIN encoder and skip decoder above."""

    def __init__(self, image_nc: int, feature_nc: int, ngf: int, img_f: int,
                 encoder_layers: int, decoder_layers: int):
        super().__init__()
        self.encoder = ADAINEncoder(image_nc, feature_nc, ngf, img_f, encoder_layers)
        self.decoder = ADAINDecoder(feature_nc, ngf, img_f, encoder_layers, decoder_layers)
        self.output_nc = self.decoder.output_nc

    def forward(self, x, z):
        return self.decoder(self.encoder(x, z), z)
