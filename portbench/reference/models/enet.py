"""ENet — StyleGAN2-style 96 -> 384 enhancer around a frozen LNet
(reference: models/ENet.py), NCHW.

- style branch: the reference crop resized to 256^2 -> 1x1 conv -> six down
  ResBlocks -> 3x3 conv -> flatten -> linear -> style code.
- low-res branch: (masked | reference) resized to 96^2 -> LNet (``low_res``).
- super-resolution: reflect-pad 2 -> [StyleConv up, StyleConv, ToRGB] x 2
  (100 -> 200 -> 400) -> centre crop 384^2.

Returns (pred [B, 3, 384, 384], low_res [B, 3, 96, 96]).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.models.layers import ResBlockENet, StyleConv, ToRGB
from portbench.reference.models.lnet import LNet
from portbench.reference.ops.image import reflect_pad_2d, resize_bilinear


def channels(narrow: float, channel_multiplier: float) -> dict:
    """ENet.py:22-32 (production: channel_multiplier 2, narrow 1)."""
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
    }


class ENet(nn.Module):
    """audio [B, 1, 80, 16]; face [B, 6, H, W] (masked | reference);
    gt [B, 3, H, W] (reference frames, the identity source)."""

    def __init__(self, num_style_feat: int = 512, lnet_res_blocks: int = 9,
                 channel_multiplier: float = 2, narrow: float = 1.0,
                 lnet_base_nc: int = 64, lnet_max_nc: int = 512):
        super().__init__()
        ch = channels(narrow, channel_multiplier)
        self.num_style_feat = num_style_feat
        self.conv_body_first = nn.Conv2d(3, ch[128], 1)
        down, cin = [], ch[128]
        for i in range(8, 2, -1):  # 256^2 -> 4^2
            down.append(ResBlockENet(cin, ch[2 ** (i - 1)]))
            cin = ch[2 ** (i - 1)]
        self.conv_body_down = nn.ModuleList(down)
        self.final_conv = nn.Conv2d(ch[4], ch[4], 3, 1, 1)
        self.final_linear = nn.Linear(ch[4] * 4 * 4, num_style_feat)
        self.low_res = LNet(num_res_blocks=lnet_res_blocks, base_nc=lnet_base_nc,
                            max_nc=lnet_max_nc)
        convs, rgbs, cin = [], [], 3
        for idx in range(2):
            c = ch[2 ** (7 + idx)]
            convs += [StyleConv(cin, c, 3, num_style_feat, sample_mode="upsample"),
                      StyleConv(c, c, 3, num_style_feat)]
            rgbs.append(ToRGB(c, num_style_feat, upsample=True))
            cin = c
        self.style_convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)

    def style_code(self, ref):
        feat = F.leaky_relu(self.conv_body_first(resize_bilinear(ref, (256, 256))), 0.2)
        for blk in self.conv_body_down:
            feat = blk(feat)
        feat = F.leaky_relu(self.final_conv(feat), 0.2)
        return self.final_linear(feat.flatten(1))[:, None]  # [B, 1, F]

    def forward(self, audio, face, gt):
        if face.dim() != 4 or face.shape[1] != 6:
            raise ValueError(f"ENet face must be [B, 6, H, W] (masked|reference), "
                             f"got {tuple(face.shape)}")
        if gt.shape[0] != face.shape[0] or gt.shape[1] != 3:
            raise ValueError(f"ENet gt must be [B, 3, H, W] with matching batch, "
                             f"got {tuple(gt.shape)}")
        style = self.style_code(face[:, 3:])
        lnet_in = resize_bilinear(torch.cat([face[:, :3], gt], dim=1), (96, 96))
        low_res = self.low_res(audio, lnet_in)
        out = skip = reflect_pad_2d(low_res, 2)  # 100^2
        for idx in range(2):  # 100 -> 200 -> 400
            out = self.style_convs[2 * idx](out, style)
            out = self.style_convs[2 * idx + 1](out, style)
            skip = self.to_rgbs[idx](out, style, skip)
        return skip[:, :, 8:-8, 8:-8], low_res


def enet_arch(state_dict) -> ENet:
    """The ENet geometry of a state_dict with its LNet under ``low_res``
    (s2v_tpu's ``LipSyncPipeline._enet_arch``): the style encoder's widths
    and the LNet's depth and widths. Reference checkpoints are the
    production geometry (ENet.py:22-32). Without those keys, the defaults,
    whose strict load then names them."""
    try:
        narrow = int(state_dict["final_conv.weight"].shape[0]) / 512.0
        ch128 = int(state_dict["conv_body_first.weight"].shape[0])
        enc = "low_res.encoder."
        return ENet(
            num_style_feat=int(state_dict["final_linear.weight"].shape[0]),
            lnet_res_blocks=len({k.split(".")[3] for k in state_dict
                                 if k.startswith("low_res.decoder.res2.")}) or 9,
            channel_multiplier=ch128 / (128.0 * narrow), narrow=narrow,
            lnet_base_nc=int(state_dict[enc + "first_inp.model.0.weight"].shape[0]),
            lnet_max_nc=max(int(v.shape[0]) for k, v in state_dict.items()
                            if k.startswith(enc + "inp_down") and k.endswith("model.0.weight")))
    except (KeyError, ValueError):  # ValueError: max() of no encoder block
        return ENet()
