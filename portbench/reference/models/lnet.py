"""LNet — audio-conditioned 96x96 lip-sync generator (reference:
models/LNet.py), NCHW.

- encoder (Visual_Encoder): masked-input and reference streams, a 7x7 first
  block then three down blocks, cross-attention from the reference stream
  at the deepest level, and the reference features concatenated at the
  bottleneck.
- audio_encoder: 13 conv + BN blocks over the [1, 80, 16] mel window -> a
  512-d vector.
- decoder: per level ``num_res_blocks`` FFC-ADAIN residual blocks
  conditioned on the audio vector, a nearest x2 up block and a jump skip;
  final 7x7 conv + sigmoid.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.models.attention import CrossTransformer
from portbench.reference.models.ffc import FFCADAINResBlocks
from portbench.reference.models.layers import (ConvBNReLU, DownBlock2d, FinalBlock2d,
                                     FirstBlock2d, Jump, UpBlock2d)

# (cout, kernel, stride, padding, residual) of audio_encoder.0 .. 12
_AUDIO_SPECS = [
    (32, 3, (1, 1), 1, False), (32, 3, (1, 1), 1, True), (32, 3, (1, 1), 1, True),
    (64, 3, (3, 1), 1, False), (64, 3, (1, 1), 1, True), (64, 3, (1, 1), 1, True),
    (128, 3, (3, 3), 1, False), (128, 3, (1, 1), 1, True), (128, 3, (1, 1), 1, True),
    (256, 3, (3, 2), 1, False), (256, 3, (1, 1), 1, True),
    (512, 3, (1, 1), 0, False), (512, 1, (1, 1), 0, False),
]


class VisualEncoder(nn.Module):
    """LNet.py:10-43."""

    def __init__(self, ngf: int = 64, img_f: int = 512, layers: int = 3):
        super().__init__()
        self.layers = layers
        self.first_inp = FirstBlock2d(3, ngf)
        self.first_ref = FirstBlock2d(3, ngf)
        cin = ngf
        for i in range(layers):
            ch = min(ngf * 2 ** (i + 1), img_f)
            self.add_module(f"inp_down{i}", DownBlock2d(cin, ch))
            self.add_module(f"ref_down{i}", DownBlock2d(cin, ch))
            if i >= 2:
                self.add_module(f"ca{i}", CrossTransformer(
                    ch, depth=2, heads=4, dim_head=ngf, mlp_dim=ngf * 4))
            cin = ch

    def forward(self, inp, ref):
        x_inp = self.first_inp(inp)
        x_ref = self.first_ref(ref)
        out = [x_inp]
        for i in range(self.layers):
            x_inp = getattr(self, f"inp_down{i}")(x_inp)
            x_ref = getattr(self, f"ref_down{i}")(x_ref)
            if i >= 2:
                x_inp = getattr(self, f"ca{i}")(x_inp, x_ref)
            out.append(x_inp if i < self.layers - 1
                       else torch.cat([x_inp, x_ref], dim=1))
        return out


class Decoder(nn.Module):
    """LNet.py:46-77."""

    def __init__(self, image_nc=3, feature_nc=512, ngf=64, img_f=512,
                 layers=3, num_block=9):
        super().__init__()
        self.layers = layers
        for i in reversed(range(layers)):
            in_ch = min(ngf * 2 ** (i + 1), img_f)
            if i == layers - 1:
                in_ch *= 2  # bottleneck concat of the inp and ref streams
            out_ch = min(ngf * 2 ** i, img_f)
            self.add_module(f"res{i}", FFCADAINResBlocks(num_block, in_ch, feature_nc))
            self.add_module(f"up{i}", UpBlock2d(in_ch, out_ch))
            self.add_module(f"jump{i}", Jump(out_ch, out_ch))
        self.final = FinalBlock2d(ngf, image_nc, "sigmoid")

    def forward(self, skips, z):
        skips = list(skips)
        out = skips.pop()
        for i in reversed(range(self.layers)):
            out = getattr(self, f"res{i}")(out, z)
            out = getattr(self, f"up{i}")(out)
            out = getattr(self, f"jump{i}")(skips.pop()) + out
        return self.final(out)


class LNet(nn.Module):
    """LNet.py:80-139. audio [B, 1, 80, 16]; face [B, 6, H, W] (masked crop |
    reference). Returns [B, 3, H, W] in [0, 1]."""

    def __init__(self, image_nc: int = 3, descriptor_nc: int = 512,
                 layers: int = 3, base_nc: int = 64, max_nc: int = 512,
                 num_res_blocks: int = 9):
        super().__init__()
        self.image_nc = image_nc
        self.encoder = VisualEncoder(base_nc, max_nc, layers)
        blocks, cin = [], 1
        for cout, k, stride, pad, res in _AUDIO_SPECS:
            cout = descriptor_nc if cout == 512 and k == 1 else cout
            blocks.append(ConvBNReLU(cin, cout, k, stride, pad, res))
            cin = cout
        self.audio_encoder = nn.Sequential(*blocks)
        self.decoder = Decoder(image_nc, descriptor_nc, base_nc, max_nc, layers,
                               num_res_blocks)

    def forward(self, audio, face):
        if audio.dim() != 4 or tuple(audio.shape[1:]) != (1, 80, 16):
            raise ValueError(
                f"LNet audio must be [B, 1, 80, 16] mel windows, got {tuple(audio.shape)}")
        if face.dim() != 4 or face.shape[1] != 2 * self.image_nc:
            raise ValueError(f"LNet face must be [B, {2 * self.image_nc}, H, W] "
                             f"(masked|reference), got {tuple(face.shape)}")
        if audio.shape[0] != face.shape[0]:
            raise ValueError(f"audio batch {audio.shape[0]} != face batch {face.shape[0]}")
        skips = self.encoder(face[:, :3], face[:, 3:])
        z = self.audio_encoder(audio).flatten(1)
        return self.decoder(skips, z)
