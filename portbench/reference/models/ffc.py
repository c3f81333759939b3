"""Fast Fourier Convolution blocks of LNet's decoder (reference:
models/ffc.py and base_blocks.py:368-426), NCHW.

Only the configuration LNet uses: ratio_gin = ratio_gout = 0.75, stride 1,
LFU disabled, ungated. Channels split [local C/4 | global 3C/4]. The
spectral path is rfft2 -> 1x1 conv over interleaved (re, im) channels ->
irfft2, 'ortho' norm, computed in f32 whatever the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.models.layers import AdaIN


class FourierUnit(nn.Module):
    """ffc.py:62-126 (no SE, no spectral positional encoding)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * cin, 2 * cout, 1, bias=False)
        self.bn = nn.BatchNorm2d(2 * cout)

    def forward(self, x):
        b, c, h, w = x.shape
        ff = torch.fft.rfft2(x.float(), norm="ortho")  # [B, C, H, W//2+1]
        # interleave (re, im) per source channel: [c0_re, c0_im, c1_re, ...]
        z = torch.stack([ff.real, ff.imag], dim=2).reshape(b, 2 * c, h, -1)
        z = F.relu(self.bn(self.conv_layer(z.to(x.dtype))))
        z = z.float().reshape(b, -1, 2, h, z.shape[-1])
        out = torch.fft.irfft2(torch.complex(z[:, :, 0], z[:, :, 1]),
                               s=(h, w), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """ffc.py:129-173, stride 1, enable_lfu=False."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.conv1 = nn.Sequential(nn.Conv2d(cin, half, 1, bias=False),
                                   nn.BatchNorm2d(half), nn.ReLU())
        self.fu = FourierUnit(half, half)
        self.conv2 = nn.Conv2d(half, cout, 1, bias=False)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(x + self.fu(x))


class FFC(nn.Module):
    """ffc.py:176-232: local/global two-stream 3x3 conv, reflect padding."""

    def __init__(self, dim: int, ratio: float = 0.75):
        super().__init__()
        cg = int(dim * ratio)
        cl = dim - cg

        def conv(i, o):
            return nn.Conv2d(i, o, 3, 1, 1, bias=False, padding_mode="reflect")

        self.convl2l = conv(cl, cl)
        self.convl2g = conv(cl, cg)
        self.convg2l = conv(cg, cl)
        self.convg2g = SpectralTransform(cg, cg)

    def forward(self, x_l, x_g):
        return (self.convl2l(x_l) + self.convg2l(x_g),
                self.convl2g(x_l) + self.convg2g(x_g))


class FineADAINLama(nn.Module):
    """base_blocks.py:368-386: FFC + per-stream ADAIN(z) + leaky ReLU.

    Slope quirk: the reference builds this block with its default
    nn.LeakyReLU(), slope 0.01 (FFCADAINResBlocks passes its arguments
    positionally into an unrelated signature); the checkpoints were trained
    with it.
    """

    def __init__(self, dim: int, feature_nc: int, ratio: float = 0.75,
                 slope: float = 0.01):
        super().__init__()
        cg = int(dim * ratio)
        self.ffc = FFC(dim, ratio)
        self.bn_l = AdaIN(dim - cg, feature_nc)
        self.bn_g = AdaIN(cg, feature_nc)
        self.slope = slope

    def forward(self, x_l, x_g, z):
        x_l, x_g = self.ffc(x_l, x_g)
        return (F.leaky_relu(self.bn_l(x_l, z), self.slope),
                F.leaky_relu(self.bn_g(x_g, z), self.slope))


class FFCResnetBlock(nn.Module):
    """base_blocks.py:389-411: split, two FineADAINLama, residual, concat."""

    def __init__(self, dim: int, feature_nc: int, ratio: float = 0.75):
        super().__init__()
        self.n_local = dim - int(dim * ratio)
        self.conv1 = FineADAINLama(dim, feature_nc, ratio)
        self.conv2 = FineADAINLama(dim, feature_nc, ratio)

    def forward(self, x, z):
        id_l, id_g = x[:, :self.n_local], x[:, self.n_local:]
        x_l, x_g = self.conv1(id_l, id_g, z)
        x_l, x_g = self.conv2(x_l, x_g, z)
        return torch.cat([id_l + x_l, id_g + x_g], dim=1)


class FFCADAINResBlocks(nn.Module):
    """base_blocks.py:414-426: ``res0`` .. ``res{n-1}``."""

    def __init__(self, num_block: int, dim: int, feature_nc: int):
        super().__init__()
        self.num_block = num_block
        for i in range(num_block):
            self.add_module(f"res{i}", FFCResnetBlock(dim, feature_nc))

    def forward(self, x, z):
        for i in range(self.num_block):
            x = getattr(self, f"res{i}")(x, z)
        return x
