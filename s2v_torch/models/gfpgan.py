"""GFPGAN v1 (clean): blind face restoration for the Step-6 mouth tail
(reference: third_part/GFPGAN/gfpgan/archs/gfpganv1_clean_arch.py +
stylegan2_clean_arch.py; GFPGANer with arch='clean', the v1.4 checkpoint:
out_size 512, channel_multiplier 2, different_w, sft_half,
input_is_latent), NCHW.

A U-Net encoder gives per-level SFT conditions (scale and shift) and the
style code; a StyleGAN2 decoder applies the conditions to half its channels
(``sft_half``). The decoder's layers are ENet's (``s2v_torch.models.layers``),
which resample bilinearly: GFPGAN runs none of the port's CUDA kernels.

Module and parameter names are the reference's, so a GFPGANv1.4 checkpoint's
``params_ema`` loads strictly through ``load_reference``. Two parts of it are
loaded and never run, as in GFPGANer's inference: the U-Net's ``toRGB``
heads (the intermediate RGB outputs nobody reads) and the decoder's stored
``noises`` (the noise strengths multiply zero noise here, as in s2v_tpu's
``deterministic=True``; ``StyleConv`` skips the injection).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.models.layers import ResBlockENet, StyleConv, ToRGB


def _channels(narrow: float, channel_multiplier: float) -> dict:
    """The reference's channel table; the ``int`` truncates float widths
    (slim test geometries use channel_multiplier 0.5 and narrow 0.5)."""
    return {4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
            32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
            128: int(128 * channel_multiplier * narrow),
            256: int(64 * channel_multiplier * narrow),
            512: int(32 * channel_multiplier * narrow),
            1024: int(16 * channel_multiplier * narrow)}


class NormStyleCode(nn.Module):
    """x / sqrt(mean(x^2) + 1e-8) over the style features."""

    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, channels, size, size))

    def forward(self, batch: int):
        return self.weight.repeat(batch, 1, 1, 1)


class StyleGAN2GeneratorCSFT(nn.Module):
    """stylegan2_clean_arch.py StyleGAN2GeneratorClean with the CSFT forward
    (gfpganv1_clean_arch.py:11-117)."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512, num_mlp: int = 8,
                 channel_multiplier: float = 2, narrow: float = 1.0, sft_half: bool = True):
        super().__init__()
        self.num_style_feat = num_style_feat
        self.sft_half = sft_half
        layers = [NormStyleCode()]
        for _ in range(num_mlp):
            layers += [nn.Linear(num_style_feat, num_style_feat), nn.LeakyReLU(0.2)]
        self.style_mlp = nn.Sequential(*layers)
        ch = _channels(narrow, channel_multiplier)
        self.log_size = int(math.log2(out_size))
        self.num_latent = self.log_size * 2 - 2
        self.constant_input = ConstantInput(ch[4])
        self.style_conv1 = StyleConv(ch[4], ch[4], 3, num_style_feat)
        self.to_rgb1 = ToRGB(ch[4], num_style_feat, upsample=False)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = nn.Module()
        for i in range((self.log_size - 2) * 2 + 1):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise{i}", torch.zeros(1, 1, res, res))
        cin = ch[4]
        for res_log in range(3, self.log_size + 1):
            cout = ch[2 ** res_log]
            self.style_convs.append(StyleConv(cin, cout, 3, num_style_feat,
                                              sample_mode="upsample"))
            self.style_convs.append(StyleConv(cout, cout, 3, num_style_feat))
            self.to_rgbs.append(ToRGB(cout, num_style_feat))
            cin = cout

    def forward(self, styles, conditions, input_is_latent: bool = False):
        latent = styles if input_is_latent else self.style_mlp(styles)
        if latent.dim() < 3:
            latent = latent[:, None].repeat(1, self.num_latent, 1)
        out = self.constant_input(latent.shape[0]).to(latent.dtype)
        out = self.style_conv1(out, latent[:, 0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for k, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * k](out, latent[:, i])
            if i < len(conditions):
                scale, shift = conditions[i - 1], conditions[i]
                if self.sft_half:
                    half = out.shape[1] // 2
                    out = torch.cat([out[:, :half], out[:, half:] * scale + shift], dim=1)
                else:
                    out = out * scale + shift
            out = self.style_convs[2 * k + 1](out, latent[:, i + 1])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip


def _condition(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cin, 3, 1, 1), nn.LeakyReLU(0.2),
                         nn.Conv2d(cin, cout, 3, 1, 1))


class GFPGANv1Clean(nn.Module):
    """gfpganv1_clean_arch.py:153-324 with s2v_tpu's defaults (the v1.4
    configuration). Input [B, 3, out_size, out_size] in [-1, 1]; returns the
    restored image in [-1, 1] (the reference's out_rgbs are not computed:
    the pipeline never reads them)."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512,
                 channel_multiplier: float = 2, num_mlp: int = 8,
                 input_is_latent: bool = True, different_w: bool = True,
                 narrow: float = 1.0, sft_half: bool = True):
        super().__init__()
        self.input_is_latent = input_is_latent
        self.different_w = different_w
        self.num_style_feat = num_style_feat
        ch = _channels(narrow * 0.5, channel_multiplier)
        self.log_size = int(math.log2(out_size))
        self.conv_body_first = nn.Conv2d(3, ch[out_size], 1)
        self.conv_body_down = nn.ModuleList()
        cin = ch[out_size]
        for i in range(self.log_size, 2, -1):
            self.conv_body_down.append(ResBlockENet(cin, ch[2 ** (i - 1)], "down"))
            cin = ch[2 ** (i - 1)]
        self.final_conv = nn.Conv2d(cin, ch[4], 3, 1, 1)
        self.conv_body_up = nn.ModuleList()
        self.toRGB = nn.ModuleList()
        self.condition_scale = nn.ModuleList()
        self.condition_shift = nn.ModuleList()
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.conv_body_up.append(ResBlockENet(cin, cout, "up"))
            self.toRGB.append(nn.Conv2d(cout, 3, 1))
            sft = cout if sft_half else cout * 2
            self.condition_scale.append(_condition(cout, sft))
            self.condition_shift.append(_condition(cout, sft))
            cin = cout
        n_w = (self.log_size * 2 - 2) if different_w else 1
        self.final_linear = nn.Linear(ch[4] * 4 * 4, n_w * num_style_feat)
        self.stylegan_decoder = StyleGAN2GeneratorCSFT(out_size, num_style_feat, num_mlp,
                                                       channel_multiplier, narrow, sft_half)

    def forward(self, x):
        feat = F.leaky_relu(self.conv_body_first(x), 0.2)
        skips = []
        for block in self.conv_body_down:
            feat = block(feat)
            skips.insert(0, feat)
        feat = F.leaky_relu(self.final_conv(feat), 0.2)
        style = self.final_linear(feat.flatten(1))
        if self.different_w:
            style = style.view(style.shape[0], -1, self.num_style_feat)
        conditions = []
        for i, up in enumerate(self.conv_body_up):
            feat = up(feat + skips[i])
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]
        return self.stylegan_decoder(style, conditions, input_is_latent=self.input_is_latent)
