"""GFPGAN v1 (clean): blind face restoration for the Step-6 mouth tail
(reference: third_part/GFPGAN/gfpgan/archs/gfpganv1_clean_arch.py +
stylegan2_clean_arch.py; GFPGANer with arch='clean', the v1.4 checkpoint:
out_size 512, channel_multiplier 2, different_w, sft_half,
input_is_latent), NCHW.

A U-Net encoder gives per-level SFT conditions (scale and shift) and the
style code; a StyleGAN2 decoder applies the conditions to half its channels
(``sft_half``). The decoder's layers are ENet's (``portbench.reference.models.layers``),
which resample bilinearly: GFPGAN runs none of the port's CUDA kernels.

Module and parameter names are the reference's, so a GFPGANv1.4 checkpoint's
``params_ema`` loads strictly through ``load_reference``. Two parts of it are
loaded and never run, as in GFPGANer's inference: the U-Net's ``toRGB``
heads (the intermediate RGB outputs nobody reads) and the decoder's stored
``noises`` (the noise strengths multiply zero noise here, as in s2v_tpu's
``deterministic=True``; ``StyleConv`` skips the injection).

``GFPGANv1`` is the *original* architecture (gfpganv1_arch.py:12-404), the
one a ``GFPGANv1.pth`` holds: the same U-Net and SFT wiring around basicsr's
StyleGAN2 decoder (blur resampling, equalized learning rate), built from the
port's GPEN layers, so its activations run the K1 kernel and its blurs and
upsamples K3 (``portbench.reference.ops.kernels``). ``forward_launches`` counts them.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.models import gpen
from portbench.reference.models.gpen import (Blur, ConvLayer, EqualConv2d, EqualLinear, FusedLeakyReLU,
                                   ResBlock, Upsample)
from portbench.reference.models.layers import ResBlockENet, StyleConv, ToRGB
from portbench.reference.ops.image import resize_bilinear


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


# ---------------------------------------------------------------------------
# GFPGANv1, the original architecture. Key names: the parameters are those
# s2v_tpu's ``convert_gfpgan_v1`` reads (``conv_body_*``, ``final_conv``,
# ``final_linear``, ``condition_{scale,shift}.i.{0,2}``, ``toRGB.i``, and in
# ``stylegan_decoder`` ``constant_input.weight``, ``style_mlp.{1..8}``,
# ``style_conv1`` / ``style_convs.k`` with ``modulated_conv.*``, the scalar
# noise strength ``weight`` and ``activate.bias``, ``to_rgb1`` / ``to_rgbs.k``
# with ``modulated_conv.*`` and ``bias``). The buffers come from basicsr's
# stylegan2_arch.py source, which the converter does not read, and no real
# GFPGANv1.pth has checked them yet: ``stylegan_decoder.noises.noise{j}``
# (registered buffers there, so required; they load and never run: zero
# noise, as s2v_tpu's ``deterministic=True``) and the constant FIRs
# ``modulated_conv.smooth.kernel`` (the upsample blur of ``style_convs.2k``),
# ``to_rgbs.k.upsample.kernel`` and ``conv_body_down.i.{conv2,skip}.0.kernel``.
# basicsr's UpFirDnSmooth / UpFirDnUpsample keep their FIR as a plain
# attribute, so a file may lack those keys: ``_fir_kernels_from_module``
# fills a missing one from the module and refuses a present one whose value
# differs.
# ---------------------------------------------------------------------------


def _fir_kernels_from_module(module, state_dict, prefix, local_metadata, strict,
                             missing_keys, unexpected_keys, error_msgs):
    """GFPGANv1's load pre-hook: every Blur / Upsample ``kernel`` key the
    file lacks is the module's constant FIR; one it holds must equal it."""
    for name, m in module.named_modules():
        if not isinstance(m, (Blur, Upsample)):
            continue
        key = f"{prefix}{name}.kernel"
        got = state_dict.get(key)
        if got is None:
            state_dict[key] = m.kernel
        elif got.shape == m.kernel.shape and not torch.allclose(
                got.to(m.kernel), m.kernel, rtol=1e-6, atol=0.0):
            error_msgs.append(f"{key}: a FIR kernel that is not the blur's "
                              f"{m.kernel.flatten().tolist()}")


class BasicsrModulatedConv2d(gpen.ModulatedConv2d):
    """basicsr's ModulatedConv2d: GPEN's, its upsample blur named ``smooth``."""

    blur_name = "smooth"


class StyleConvV1(nn.Module):
    """basicsr's StyleConv: modulated conv, additive noise (a scalar
    strength ``weight``; the noise is zero here, so it is skipped), then
    FusedLeakyReLU over ``cout`` channels (K1)."""

    def __init__(self, cin, cout, kernel, style_dim, upsample=False):
        super().__init__()
        self.modulated_conv = BasicsrModulatedConv2d(cin, cout, kernel, style_dim,
                                                     upsample=upsample)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, style):
        return self.activate(self.modulated_conv(x, style))


class ToRGBV1(nn.Module):
    """basicsr's ToRGB: a 1x1 modulated conv without demodulation plus
    ``bias``, and the previous level's image upsampled by K3."""

    def __init__(self, cin, style_dim, upsample=True):
        super().__init__()
        if upsample:
            self.upsample = Upsample()
        self.modulated_conv = BasicsrModulatedConv2d(cin, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class StyleGAN2GeneratorSFT(nn.Module):
    """gfpganv1_arch.py:12-131: basicsr's StyleGAN2Generator with the SFT
    conditions applied after each level's upsampling StyleConv."""

    def __init__(self, out_size=512, num_style_feat=512, num_mlp=8, channel_multiplier=1,
                 narrow=1.0, sft_half=False):
        super().__init__()
        ch = gpen.channels_table(narrow, channel_multiplier)
        self.sft_half = sft_half
        self.log_size = int(math.log2(out_size))
        self.num_latent = self.log_size * 2 - 2
        self.style_mlp = nn.Sequential(gpen.PixelNorm(), *[
            EqualLinear(num_style_feat, num_style_feat, lr_mul=0.01, activation="fused_lrelu")
            for _ in range(num_mlp)])
        self.constant_input = ConstantInput(ch[4])
        self.style_conv1 = StyleConvV1(ch[4], ch[4], 3, num_style_feat)
        self.to_rgb1 = ToRGBV1(ch[4], num_style_feat, upsample=False)
        self.style_convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        self.noises = nn.Module()
        for i in range((self.log_size - 2) * 2 + 1):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise{i}", torch.zeros(1, 1, res, res))
        cin = ch[4]
        for res_log in range(3, self.log_size + 1):
            cout = ch[2 ** res_log]
            self.style_convs.append(StyleConvV1(cin, cout, 3, num_style_feat, upsample=True))
            self.style_convs.append(StyleConvV1(cout, cout, 3, num_style_feat))
            self.to_rgbs.append(ToRGBV1(cout, num_style_feat))
            cin = cout

    def forward(self, styles, conditions, input_is_latent: bool = False):
        latent = styles
        if not input_is_latent:  # normalised over the style axis, as s2v_tpu
            shape = latent.shape
            latent = latent.reshape(-1, shape[-1])
            latent = self.style_mlp(latent).reshape(shape)
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
                if self.sft_half:  # SFT on the second half of the channels
                    half = out.shape[1] // 2
                    out = torch.cat([out[:, :half], out[:, half:] * scale + shift], dim=1)
                else:
                    out = out * scale + shift
            out = self.style_convs[2 * k + 1](out, latent[:, i + 1])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip


class ConvUpLayer(nn.Module):
    """gfpganv1_arch.py:132-196: bilinear x2, an equalized conv, then
    FusedLeakyReLU (K1) when ``activate`` (the conv takes the bias
    otherwise)."""

    def __init__(self, cin, cout, kernel, padding=0, bias=True, activate=True):
        super().__init__()
        if activate and not bias:
            raise ValueError("ConvUpLayer(activate=True, bias=False) (ScaledLeakyReLU) has no "
                             "user in GFPGANv1 and is not ported")
        self.weight = nn.Parameter(torch.randn(cout, cin, kernel, kernel))
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.padding = padding
        self.bias = nn.Parameter(torch.zeros(cout)) if bias and not activate else None
        self.activation = FusedLeakyReLU(cout) if activate else None

    def forward(self, x):
        out = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))
        b = None if self.bias is None else self.bias.to(out.dtype)
        out = F.conv2d(out, (self.weight * self.scale).to(out.dtype), b, padding=self.padding)
        return out if self.activation is None else self.activation(out)


class ResUpBlock(nn.Module):
    """gfpganv1_arch.py:197-219."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin, 3)
        self.conv2 = ConvUpLayer(cin, cout, 3, padding=1)
        self.skip = ConvUpLayer(cin, cout, 1, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class ScaledLeakyReLU(nn.Module):
    """sqrt(2) * leaky_relu(x, 0.2), no bias (plain: s2v_tpu runs it as a
    ``jnp.where``)."""

    def forward(self, x):
        return F.leaky_relu(x, 0.2) * math.sqrt(2.0)


def _condition_v1(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(EqualConv2d(cin, cin, 3, 1, 1), ScaledLeakyReLU(),
                         EqualConv2d(cin, cout, 3, 1, 1))


class GFPGANv1(nn.Module):
    """gfpganv1_arch.py:221-404. The defaults are the class's (channel
    multiplier 1, ``different_w``, ``sft_half`` and ``input_is_latent``
    off); GFPGANer builds a GFPGANv1.pth with all three on
    (gfpgan/utils.py:63-74). Input [B, 3, out_size, out_size] in [-1, 1];
    returns (the image in [-1, 1], the U-Net's ``toRGB`` images), as
    s2v_tpu's, which returns the second and reads it nowhere."""

    def __init__(self, out_size=512, num_style_feat=512, channel_multiplier=1,
                 different_w=False, narrow=1.0, sft_half=False, input_is_latent=False,
                 num_mlp=8):
        super().__init__()
        self.input_is_latent = input_is_latent
        self.different_w = different_w
        self.num_style_feat = num_style_feat
        self.num_mlp = num_mlp
        ch = _channels(narrow * 0.5, channel_multiplier)
        self.log_size = int(math.log2(out_size))
        self.conv_body_first = ConvLayer(3, ch[out_size], 1)
        self.conv_body_down = nn.ModuleList()
        cin = ch[out_size]
        for i in range(self.log_size, 2, -1):
            self.conv_body_down.append(ResBlock(cin, ch[2 ** (i - 1)]))
            cin = ch[2 ** (i - 1)]
        self.final_conv = ConvLayer(cin, ch[4], 3)
        self.conv_body_up, self.toRGB = nn.ModuleList(), nn.ModuleList()
        self.condition_scale, self.condition_shift = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.conv_body_up.append(ResUpBlock(cin, cout))
            self.toRGB.append(EqualConv2d(cout, 3, 1))
            sft = cout if sft_half else cout * 2
            self.condition_scale.append(_condition_v1(cout, sft))
            self.condition_shift.append(_condition_v1(cout, sft))
            cin = cout
        n_w = (self.log_size * 2 - 2) if different_w else 1
        self.final_linear = EqualLinear(ch[4] * 4 * 4, n_w * num_style_feat)
        self.stylegan_decoder = StyleGAN2GeneratorSFT(out_size, num_style_feat, num_mlp,
                                                      channel_multiplier, narrow, sft_half)
        self.register_load_state_dict_pre_hook(_fir_kernels_from_module)

    def forward(self, x):
        feat = self.conv_body_first(x)
        skips = []
        for block in self.conv_body_down:
            feat = block(feat)
            skips.insert(0, feat)
        feat = self.final_conv(feat)
        style = self.final_linear(feat.flatten(1))
        if self.different_w:
            style = style.view(style.shape[0], -1, self.num_style_feat)
        conditions, out_rgbs = [], []
        for i, up in enumerate(self.conv_body_up):
            feat = up(feat + skips[i])
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]
            out_rgbs.append(self.toRGB[i](feat))
        image = self.stylegan_decoder(style, conditions, input_is_latent=self.input_is_latent)
        return image, out_rgbs


def forward_launches(model: nn.Module) -> dict:
    """K1 and K3 launches of one forward of ``model`` (a GFPGANv1 or
    GFPGANv1Clean), from its kernel sites: every FusedLeakyReLU, the style
    MLP's fused EqualLinears when it runs (not under ``input_is_latent``),
    every Blur and Upsample. GFPGANv1(512): 45 and 28; GFPGANv1Clean
    upsamples bilinearly and has none."""
    mods = list(model.modules())
    k1 = sum(isinstance(m, FusedLeakyReLU) for m in mods)
    if isinstance(model, GFPGANv1) and not model.input_is_latent:
        k1 += model.num_mlp
    k3 = sum(isinstance(m, (Blur, Upsample)) for m in mods)
    return {"fused_act": k1, "fused_act_bwd": 0, "upfirdn2d": k3}


def gfpgan_arch(state_dict, out_size: int = 512, arch: str = "clean", **kw) -> nn.Module:
    """The GFPGAN geometry of a checkpoint's ``params_ema`` (s2v_tpu's
    ``gfpgan_arch``): narrow, channel multiplier, the style MLP's depth and
    the style width. ``arch`` "clean" builds GFPGANv1Clean (the v1.3/v1.4
    files, whose style width is per latent: ``different_w``), "original"
    GFPGANv1 (GFPGANv1.pth). ``out_size`` and the wiring flags in ``kw``
    (``different_w``, ``sft_half``, ``input_is_latent``) are the caller's,
    as gfpgan/utils.py picks them per file; they override what is read.
    GFPGANv1.3/1.4 are the production widths (gfpgan/utils.py:43-82).
    Without those keys, the defaults, whose strict load then names them."""
    cls, conv = ((GFPGANv1Clean, "{}.weight") if arch == "clean"
                 else (GFPGANv1, "{}.0.weight"))
    kw = dict(kw)
    if cls is GFPGANv1Clean:
        kw.setdefault("different_w", True)
    try:
        unet_narrow = int(state_dict[conv.format("final_conv")].shape[0]) / 512.0
        cm = (int(state_dict[conv.format("conv_body_first")].shape[0])
              / _channels(unet_narrow, 1)[out_size])
        out_dim = int(state_dict["final_linear.weight"].shape[0])
        n_latent = 2 * int(math.log2(out_size)) - 2
        num_mlp = sum(1 for k in state_dict
                      if k.startswith("stylegan_decoder.style_mlp.") and k.endswith(".weight"))
        per_latent = kw.get("different_w", False) and out_dim % n_latent == 0
        inferred = dict(out_size=out_size,
                        num_style_feat=out_dim // n_latent if per_latent else out_dim,
                        channel_multiplier=int(cm) if cm == int(cm) else cm,
                        narrow=2.0 * unet_narrow, num_mlp=num_mlp or 8)
        return cls(**{**inferred, **kw})
    except (KeyError, ZeroDivisionError):
        return cls(out_size=out_size, **kw)
