"""GANimation SplitGenerator: AU-conditioned upper-face expression editing
for ``--up_face`` (reference: third_part/ganimation_replicate/model/
model_utils.py:419-482, driven by GANimationModel in model/ganimation.py:
6-58; s2v_tpu/models/ganimation.py), NCHW.

The configuration in use: img_nc 3, aus_nc 17, ngf 64, InstanceNorm without
affine parameters, zero padding, 6 resnet blocks, no dropout. The model
predicts a colour mask and an attention (AU) mask; the edited face is
``aus_mask * src + (1 - aus_mask) * color_mask`` (ganimation.py:52-53).

Key names are the reference's: one ``nn.Sequential`` ``model`` (head conv
0, down convs 3 and 6, resnet blocks 9-14 with ``conv_block.0`` and
``conv_block.3``, transposed convs 15 and 18; the instance norms and ReLUs
between them hold no parameters) and the ``color_top.0`` / ``au_top.0``
heads, so a ``30_net_gen.pth`` loads strictly.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from s2v_torch.ops.norms import instance_norm_2d

# AU templates for --up_face (futils/inference_utils.py:53-57)
EXP_AUS = {
    "sad": [0.0] * 17,
    "angry": [0, 0, 0.3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "surprise": [0, 0, 0, 0.2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
}


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(affine=False)``, statistics in f32."""

    def forward(self, x):
        return instance_norm_2d(x)


class ResnetBlock(nn.Module):
    """model_utils.py:209-248 with zero padding and no dropout."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.Conv2d(dim, dim, 3, padding=1), InstanceNorm(), nn.ReLU(),
            nn.Conv2d(dim, dim, 3, padding=1), InstanceNorm())

    def forward(self, x):
        return x + self.conv_block(x)


def _conv_norm_relu(conv: nn.Module) -> list:
    return [conv, InstanceNorm(), nn.ReLU()]


class SplitGenerator(nn.Module):
    """img [B, 3, 128, 128] in [-1, 1], aus [B, 17] -> (color_mask (tanh),
    aus_mask (sigmoid), features)."""

    def __init__(self, img_nc: int = 3, aus_nc: int = 17, ngf: int = 64, n_blocks: int = 6):
        super().__init__()
        self.aus_nc = aus_nc
        layers = _conv_norm_relu(nn.Conv2d(img_nc + aus_nc, ngf, 7, padding=3))
        for i in range(2):
            mult = 2 ** i
            layers += _conv_norm_relu(nn.Conv2d(ngf * mult, ngf * mult * 2, 4, 2, 1))
        layers += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += _conv_norm_relu(nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 4, 2, 1))
        self.model = nn.Sequential(*layers)
        self.color_top = nn.Sequential(nn.Conv2d(ngf, img_nc, 7, padding=3, bias=False),
                                       nn.Tanh())
        self.au_top = nn.Sequential(nn.Conv2d(ngf, 1, 7, padding=3, bias=False), nn.Sigmoid())

    def forward(self, img, aus):
        b, _, h, w = img.shape
        sparse = aus.to(img.dtype)[:, :, None, None].expand(b, self.aus_nc, h, w)
        x = self.model(torch.cat([img, sparse], dim=1))
        return self.color_top(x), self.au_top(x), x


def apply_expression(src_img, color_mask, aus_mask):
    """ganimation.py:53: the attention composite."""
    return aus_mask * src_img + (1.0 - aus_mask) * color_mask


def ganimation_arch(state_dict) -> SplitGenerator:
    """The SplitGenerator geometry of a checkpoint's state_dict: ngf from the
    head conv, the number of resnet blocks from the ``model.N.conv_block``
    keys. Without those keys, the defaults, whose strict load then names
    them."""
    try:
        ngf = int(state_dict["model.0.weight"].shape[0])
        blocks = {k.split(".")[1] for k in state_dict
                  if k.startswith("model.") and ".conv_block." in k}
        return SplitGenerator(ngf=ngf, n_blocks=len(blocks))
    except KeyError:
        return SplitGenerator()
