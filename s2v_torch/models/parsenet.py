"""ParseNet — 19-class face parsing (reference:
third_part/GPEN/face_parse/parse_model.py + blocks.py), NCHW. GPEN's
enhancer uses it for the full-face blending mask, the Step-6 mouth tail for
the mouth mask (``MOUTH_COLORMAP``).

Production configuration: 512 in and out, min feature size 32 (4 down, 4
up), base 64 channels clipped to [32, 256], 10-block body, BatchNorm +
LeakyReLU(0.2).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.ops.image import resize_nearest


class NormLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(channels)

    def forward(self, x):
        return self.norm(x)


class ConvLayer(nn.Module):
    """blocks.py ConvLayer: [nearest x2] -> reflect pad -> conv[stride] ->
    [BN] -> [leaky ReLU 0.2]."""

    def __init__(self, cin, cout, kernel=3, scale="none", norm="none",
                 relu="none"):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.pad = int(np.ceil((kernel - 1.0) / 2))
        self.conv2d = nn.Conv2d(cin, cout, kernel, 2 if scale == "down" else 1,
                                bias=norm != "bn")
        if norm == "bn":
            self.norm = NormLayer(cout)

    def forward(self, x):
        if self.scale == "up":
            x = resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3]))
        x = self.conv2d(F.pad(x, [self.pad] * 4, mode="reflect"))
        if hasattr(self, "norm"):
            x = self.norm(x)
        if self.relu == "leakyrelu":
            x = F.leaky_relu(x, 0.2)
        return x


class ResidualBlock(nn.Module):
    """blocks.py ResidualBlock."""

    def __init__(self, cin, cout, scale="none"):
        super().__init__()
        if not (scale == "none" and cin == cout):
            self.shortcut_func = ConvLayer(cin, cout, 3, scale)
        conf = {"down": ("none", "down"), "up": ("up", "none"),
                "none": ("none", "none")}[scale]
        self.conv1 = ConvLayer(cin, cout, 3, conf[0], "bn", "leakyrelu")
        self.conv2 = ConvLayer(cout, cout, 3, conf[1], "bn")

    def forward(self, x):
        identity = self.shortcut_func(x) if hasattr(self, "shortcut_func") else x
        return identity + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    """parse_model.py:22-75. Returns (mask logits [B, 19, H, W], image)."""

    def __init__(self, in_size=512, out_size=512, min_feat_size=32, base_ch=64,
                 parsing_ch=19, res_depth=10, min_ch=32, max_ch=256):
        super().__init__()

        def clip(c):
            return max(min_ch, min(c, max_ch))

        down_steps = int(np.log2(in_size // min_feat_size))
        up_steps = int(np.log2(out_size // min_feat_size))
        enc = [ConvLayer(3, base_ch, 3)]
        head = base_ch
        for _ in range(down_steps):
            enc.append(ResidualBlock(clip(head), clip(head * 2), "down"))
            head *= 2
        self.encoder = nn.Sequential(*enc)
        self.body = nn.Sequential(*[ResidualBlock(clip(head), clip(head))
                                    for _ in range(res_depth)])
        dec = []
        for _ in range(up_steps):
            dec.append(ResidualBlock(clip(head), clip(head // 2), "up"))
            head //= 2
        self.decoder = nn.Sequential(*dec)
        self.out_img_conv = ConvLayer(clip(head), 3)
        self.out_mask_conv = ConvLayer(clip(head), parsing_ch)

    def forward(self, x):
        feat = self.encoder(x)
        out = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(out), self.out_img_conv(out)


# the Step-6 mouth mask colormap (inference.py:304): mouth, upper and lower
# lip (classes 10-12) only
MOUTH_COLORMAP = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 255, 255, 255, 0, 0, 0, 0, 0, 0]


def parse_mask(logits: torch.Tensor, colormap: Sequence[float]) -> torch.Tensor:
    """[B, 19, H, W] logits -> [B, H, W] float mask: argmax (first maximum on
    ties), then the class's colormap value (face_parsing.py tenor2mask)."""
    cmap = torch.as_tensor(colormap, dtype=torch.float32, device=logits.device)
    return cmap[torch.argmax(logits, dim=1)]
