"""GPEN — GAN-prior blind face restoration (reference:
third_part/GPEN/face_model/gpen_model.py), NCHW. The final full-frame stage
runs ``FullGenerator(size=2048)`` (GPEN-BFR-2048); adversarial training
(``portbench.reference.train.gan``) pairs a ``FullGenerator`` with the
``Discriminator``; ``FullGeneratorSR`` is the super-resolving variant
(GPEN-BFR-2048-SR's layout: a smaller encoder under a larger generator).

A CNN encoder produces a latent and one feature map per resolution; a
StyleGAN2 generator consumes the latent while the encoder features are
concatenated to its activations as "noise" (NoiseInjection with isconcat).

Two hand-written CUDA kernels carry the StyleGAN2 primitives on the card:
``fused_bias_leaky_relu`` (EqualLinear with fused_lrelu, StyledConv,
ConvLayer) and ``upfirdn2d`` (blur after each transposed conv, the encoder's
downsample blur, the ToRGB skip upsample). Modulated convs fold modulation
and demodulation into input and output channel scales around one shared
conv, including the transposed-conv upsample.

Both kernels are ``torch.autograd.Function``s whose backward and double
backward (R1) are kernels too.

Blur FIRs are registered as buffers named ``kernel`` where the reference
registers them, so a GPEN checkpoint's ``state_dict`` loads as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.ops.kernels import fused_bias_leaky_relu, upfirdn2d

BLUR_TAPS = (1, 3, 3, 1)


def make_kernel(k) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def channels_table(narrow: float, channel_multiplier: float) -> dict:
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
        2048: int(8 * channel_multiplier * narrow),
    }


class _Fir(nn.Module):
    """Holds a FIR as the reference's ``kernel`` buffer (Blur, Upsample)."""

    def __init__(self, kernel: np.ndarray):
        super().__init__()
        self.fir = np.asarray(kernel, np.float32)  # host copy for the launch
        self.register_buffer("kernel", torch.from_numpy(self.fir.copy()))


class EqualConv2d(nn.Module):
    """gpen_model.py:101-135: weight scaled by 1/sqrt(fan_in) at run time."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, kernel, kernel))
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.stride, self.padding = stride, padding
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, (self.weight * self.scale).to(x.dtype), b,
                        stride=self.stride, padding=self.padding)


class EqualLinear(nn.Module):
    """gpen_model.py:138-171."""

    def __init__(self, cin, cout, bias_init=0.0, lr_mul=1.0, activation=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) / lr_mul)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(cin)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, (self.weight * self.scale).to(x.dtype))
        if self.activation == "fused_lrelu":
            return fused_bias_leaky_relu(out, self.bias * self.lr_mul)
        return out + (self.bias * self.lr_mul).to(out.dtype)


class FusedLeakyReLU(nn.Module):
    """Holds the activation's bias; the op is the K1 kernel."""

    def __init__(self, channel: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))

    def forward(self, x):
        return fused_bias_leaky_relu(x, self.bias)


class Blur(_Fir):
    def __init__(self, pad, upsample_factor: int = 1):
        super().__init__(make_kernel(BLUR_TAPS) * upsample_factor ** 2)
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, self.fir, pad=self.pad)


class Upsample(_Fir):
    """gpen_model.py:37-55 (factor 2)."""

    def __init__(self):
        super().__init__(make_kernel(BLUR_TAPS) * 4)
        p = self.kernel.shape[0] - 2
        self.pad = ((p + 1) // 2 + 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.fir, up=2, pad=self.pad)


class ModulatedConv2d(nn.Module):
    """gpen_model.py:187-283 as input/output-scaled shared convs. The
    upsample's blur is registered under ``blur_name`` (basicsr's StyleGAN2
    calls it ``smooth``)."""

    blur_name = "blur"

    def __init__(self, cin, cout, kernel, style_dim, demodulate=True,
                 upsample=False):
        super().__init__()
        self.kernel_size, self.upsample, self.demodulate = kernel, upsample, demodulate
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.weight = nn.Parameter(torch.randn(1, cout, cin, kernel, kernel))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0)
        if upsample:
            p = (len(BLUR_TAPS) - 2) - (kernel - 1)
            self.add_module(self.blur_name,
                            Blur(((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2))

    def forward(self, x, style):
        w = self.weight[0] * self.scale  # [Cout, Cin, k, k]
        s = self.modulation(style)  # [B, Cin]
        xs = x * s[:, :, None, None].to(x.dtype)
        if self.upsample:
            out = F.conv_transpose2d(xs, w.transpose(0, 1).to(x.dtype), stride=2)
        else:
            out = F.conv2d(xs, w.to(x.dtype), padding=self.kernel_size // 2)
        if self.demodulate:
            w2 = w.float().square().sum(dim=(2, 3))  # [Cout, Cin]
            demod = torch.rsqrt(s.float().square() @ w2.t() + 1e-8)
            out = out * demod[:, :, None, None].to(out.dtype)
        if self.upsample:
            out = getattr(self, self.blur_name)(out)
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class StyledConv(nn.Module):
    """gpen_model.py:316-352: modconv -> concat encoder "noise" -> fused act.
    A level without encoder features (``noise`` None, FullGeneratorSR's
    levels above its input size) concatenates zeros under
    ``deterministic``, else a standard normal draw from ``generator`` (a
    ``torch.Generator`` on the activations' device): the activation still
    runs over all ``2 * cout`` channels."""

    def __init__(self, cin, cout, kernel, style_dim, upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, kernel, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(cout * 2)

    def forward(self, x, style, noise, deterministic=True, generator=None):
        out = self.conv(x, style)
        if noise is None:
            if deterministic:
                noise = torch.zeros_like(out)
            elif generator is None:
                raise ValueError("StyledConv: random noise needs a torch.Generator")
            else:
                noise = torch.randn(out.shape, generator=generator, device=out.device,
                                    dtype=out.dtype)
        noise = self.noise.weight.to(out.dtype) * noise.to(out.dtype)
        return self.activate(torch.cat([out, noise], dim=1))


class ToRGB(nn.Module):
    """gpen_model.py:355-377."""

    def __init__(self, cin, style_dim, upsample=True):
        super().__init__()
        if upsample:
            self.upsample = Upsample()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class ConvLayer(nn.Sequential):
    """gpen_model.py:557-605: [Blur,] an EqualConv2d, then FusedLeakyReLU
    when ``activate``. The conv takes a bias exactly when ``bias and not
    activate`` (the activation holds it otherwise), as s2v_tpu's ConvLayer
    ``use_bias``. Three variants are used: (bias, activate) in the GPEN
    models and the component discriminator, (bias, no activation) for the
    component discriminator's ``final_conv``, and neither for ResBlock's
    skip. The reference's fourth, a scaled leaky ReLU without bias, has no
    user and raises."""

    def __init__(self, cin, cout, kernel, downsample=False, bias=True, activate=True):
        if activate and not bias:
            raise ValueError("ConvLayer(activate=True, bias=False) (ScaledLeakyReLU) "
                             "is not ported")
        layers = []
        if downsample:
            p = (len(BLUR_TAPS) - 2) + (kernel - 1)
            layers.append(Blur(((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel // 2
        layers.append(EqualConv2d(cin, cout, kernel, stride, padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(cout))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """gpen_model.py:607-626 (the Discriminator's block)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin, 3)
        self.conv2 = ConvLayer(cin, cout, 3, downsample=True)
        self.skip = ConvLayer(cin, cout, 1, downsample=True, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class Generator(nn.Module):
    """gpen_model.py:380-551 with isconcat (GAN-prior) noise."""

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 lr_mlp=0.01, narrow=1.0):
        super().__init__()
        ch = channels_table(narrow, channel_multiplier)
        log_size = int(math.log2(size))
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp)])
        self.input = nn.Module()
        self.input.input = nn.Parameter(torch.randn(1, ch[4], 4, 4))
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim)
        self.to_rgb1 = ToRGB(ch[4] * 2, style_dim, upsample=False)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for i in range(3, log_size + 1):
            cout = ch[2 ** i]
            self.convs.append(StyledConv(cin * 2, cout, 3, style_dim, upsample=True))
            self.convs.append(StyledConv(cout * 2, cout, 3, style_dim))
            self.to_rgbs.append(ToRGB(cout * 2, style_dim))
            cin = cout

    def forward(self, styles, noise, deterministic=True, generator=None):
        latent = self.style(styles)  # [B, style_dim]; every layer's latent
        out = self.input.input.to(latent.dtype).repeat(latent.shape[0], 1, 1, 1)
        kw = dict(deterministic=deterministic, generator=generator)
        out = self.conv1(out, latent, noise[0], **kw)
        skip = self.to_rgb1(out, latent)
        for k, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * k](out, latent, noise[2 * k + 1], **kw)
            out = self.convs[2 * k + 1](out, latent, noise[2 * k + 2], **kw)
            skip = to_rgb(out, latent, skip)
        return skip


class FullGenerator(nn.Module):
    """gpen_model.py:628-690: encoder -> latent + per-level features as the
    generator's concat noise; input and output at ``size``."""

    def __init__(self, size=512, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0):
        super().__init__()
        self._build(size, size, style_dim, n_mlp, channel_multiplier, narrow)

    def _build(self, in_size, out_size, style_dim, n_mlp, channel_multiplier, narrow):
        ch = channels_table(narrow, channel_multiplier)
        self.log_size = int(math.log2(in_size))
        self.free_levels = int(math.log2(out_size)) - self.log_size
        self.generator = Generator(out_size, style_dim, n_mlp, channel_multiplier,
                                   narrow=narrow)
        self.ecd0 = nn.Sequential(ConvLayer(3, ch[in_size], 1))
        cin = ch[in_size]
        for idx, i in enumerate(range(self.log_size, 2, -1)):
            cout = ch[2 ** (i - 1)]
            self.add_module(f"ecd{idx + 1}",
                            nn.Sequential(ConvLayer(cin, cout, 3, downsample=True)))
            cin = cout
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, style_dim, activation="fused_lrelu"))

    def encode(self, x):
        """(latent, the generator's noise list): the encoder's features, each
        twice, deepest first, the first dropped; ``None`` for the levels
        above the input size."""
        feats = [None] * self.free_levels
        for idx in range(self.log_size - 1):
            x = getattr(self, f"ecd{idx}")(x)
            feats.append(x)
        latent = self.final_linear(x.flatten(1))
        return latent, [f for f in feats for _ in range(2)][::-1][1:]

    def forward(self, x):
        return self.generator(*self.encode(x))


class FullGeneratorSR(FullGenerator):
    """gpen_model.py:752-818: an ``in_size`` encoder and an ``out_size``
    generator; the generator levels above ``in_size`` take no encoder
    features (zeros under ``deterministic``, else noise drawn from
    ``generator``: see ``StyledConv``). The reference FullGenerator_SR's
    key names, which are FullGenerator's."""

    def __init__(self, in_size=512, out_size=2048, style_dim=512, n_mlp=8,
                 channel_multiplier=2, narrow=1.0):
        nn.Module.__init__(self)
        self._build(in_size, out_size, style_dim, n_mlp, channel_multiplier, narrow)

    def forward(self, x, deterministic=True, generator=None):
        return self.generator(*self.encode(x), deterministic=deterministic,
                              generator=generator)


def minibatch_stddev(out: torch.Tensor) -> torch.Tensor:
    """The population standard deviation of ``out`` [B, C, H, W] over the
    batch, averaged over C*H*W (the port's version over a process group's
    ranks is not copied)."""
    return torch.sqrt(out.var(0, unbiased=False) + 1e-8).mean()


class Discriminator(nn.Module):
    """gpen_model.py:692-750 as the JAX package computes it
    (s2v_tpu/models/gpen.py Discriminator): the minibatch-stddev channel is
    the population standard deviation over the whole batch, averaged over
    C*H*W (the reference uses groups of 4). Key layout as the
    reference's (``convs.N.conv1/conv2/skip``, ``final_conv``,
    ``final_linear.0/1``, Blur ``kernel`` buffers), so a GPEN discriminator
    checkpoint loads as it is."""

    def __init__(self, size=512, channel_multiplier=2, narrow=1.0):
        super().__init__()
        ch = channels_table(narrow, channel_multiplier)
        convs = [ConvLayer(3, ch[size], 1)]
        cin = ch[size]
        for i in range(int(math.log2(size)), 2, -1):
            convs.append(ResBlock(cin, ch[2 ** (i - 1)]))
            cin = ch[2 ** (i - 1)]
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(cin + 1, ch[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu"),
            EqualLinear(ch[4], 1))

    def forward(self, x):
        out = self.convs(x)
        b, _, h, w = out.shape
        std = minibatch_stddev(out)
        out = torch.cat([out, std.expand(b, 1, h, w).to(out.dtype)], 1)
        return self.final_linear(self.final_conv(out).flatten(1))


def fullgenerator_arch(state_dict, size: int = 512) -> FullGenerator:
    """The FullGenerator geometry of a checkpoint's state_dict (s2v_tpu's
    ``fullgenerator_arch``): narrow, style_dim, n_mlp and the channel
    multiplier. GPEN-BFR checkpoints are the production table
    (gpen_model.py:640-652). ``size`` is the caller's: it is a resolution,
    not readable from the widths. Without those keys, the defaults at
    ``size``, whose strict load then names them."""
    try:
        narrow = int(state_dict["generator.input.input"].shape[1]) / 512.0
        kw = dict(size=size, narrow=narrow,
                  style_dim=int(state_dict["final_linear.0.weight"].shape[0]),
                  n_mlp=sum(1 for k in state_dict
                            if k.startswith("generator.style.") and k.endswith(".weight")))
        if size >= 64:  # the multiplier reaches the table at 64^2 and up
            cm = int(state_dict["ecd0.0.0.weight"].shape[0]) / channels_table(narrow, 1)[size]
            kw["channel_multiplier"] = int(cm) if cm == int(cm) else cm
        return FullGenerator(**kw)
    except (KeyError, ZeroDivisionError):
        return FullGenerator(size=size)


def full_generator_sr_arch(state_dict, in_size: int = 512,
                           out_size: int = 2048) -> FullGeneratorSR:
    """The FullGeneratorSR geometry of a checkpoint's state_dict, as
    ``fullgenerator_arch`` reads it: narrow, style_dim, n_mlp, and the
    channel multiplier from the generator's last level (``out_size`` is at
    least 64^2 in every SR file). The sizes are the caller's. Without those
    keys, the defaults, whose strict load then names them."""
    try:
        narrow = int(state_dict["generator.input.input"].shape[1]) / 512.0
        last = int(math.log2(out_size)) * 2 - 5  # the generator's last StyledConv
        cm = (int(state_dict[f"generator.convs.{last}.conv.weight"].shape[1])
              / channels_table(narrow, 1)[out_size])
        return FullGeneratorSR(
            in_size, out_size, narrow=narrow,
            style_dim=int(state_dict["final_linear.0.weight"].shape[0]),
            n_mlp=sum(1 for k in state_dict
                      if k.startswith("generator.style.") and k.endswith(".weight")),
            channel_multiplier=int(cm) if cm == int(cm) else cm)
    except (KeyError, ZeroDivisionError):
        return FullGeneratorSR(in_size, out_size)
