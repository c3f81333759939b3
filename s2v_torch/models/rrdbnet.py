"""RRDBNet (Real-ESRGAN) — the RealESRNet x2 background super-resolution of
GPEN's final enhancement (reference: third_part/GPEN/sr_model/
rrdbnet_arch.py), NCHW, input in [0, 1], and the reference's tiled
forward (``tile_process``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.ops.image import resize_nearest


def _conv(cin, cout):
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat=64, num_grow_ch=32):
        super().__init__()
        for k in range(1, 5):
            self.add_module(f"conv{k}", _conv(num_feat + (k - 1) * num_grow_ch, num_grow_ch))
        self.conv5 = _conv(num_feat + 4 * num_grow_ch, num_feat)

    def forward(self, x):
        feats = [x]
        for k in range(1, 5):
            feats.append(F.leaky_relu(getattr(self, f"conv{k}")(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """rrdbnet_arch.py:66-116. scale 2 and 1 pixel-unshuffle the input first
    (channel order c * s^2 + dy * s + dx, ``F.pixel_unshuffle``'s)."""

    def __init__(self, num_in_ch=3, num_out_ch=3, scale=4, num_feat=64,
                 num_block=23, num_grow_ch=32):
        super().__init__()
        self.scale = scale
        cin = num_in_ch * {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = _conv(cin, num_feat)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch) for _ in range(num_block)])
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)

    def forward(self, x):
        if self.scale in (1, 2):
            x = F.pixel_unshuffle(x, 4 // self.scale)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            h, w = feat.shape[-2:]
            feat = F.leaky_relu(conv(resize_nearest(feat, (2 * h, 2 * w))), 0.2)
        return self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))


def tile_process(apply_fn, img: torch.Tensor, scale: int, tile_size: int = 256,
                 tile_pad: int = 10) -> torch.Tensor:
    """Tiled super-resolution (reference: sr_model/real_esrnet.py:32-100;
    s2v_tpu's ``tile_process``): each ``tile_size`` square of ``img`` [B, C,
    H, W] is upscaled with ``tile_pad`` pixels of context by ``apply_fn``
    ([B, C, th, tw] -> [B, C, th * scale, tw * scale]) and its own region
    cut from the result. Every window has one shape, (th, tw) = the padded
    tile clipped to the image, so its origin is clamped to the image
    instead of the window being cut at the borders. Returns float32 [B, C,
    H * scale, W * scale] on ``img``'s device."""
    b, c, h, w = img.shape
    out = torch.zeros((b, c, h * scale, w * scale), dtype=torch.float32, device=img.device)
    th, tw = min(tile_size + 2 * tile_pad, h), min(tile_size + 2 * tile_pad, w)
    for sy in range(0, h, tile_size):
        for sx in range(0, w, tile_size):
            ey, ex = min(sy + tile_size, h), min(sx + tile_size, w)
            py0 = min(max(sy - tile_pad, 0), h - th)
            px0 = min(max(sx - tile_pad, 0), w - tw)
            up = apply_fn(img[:, :, py0:py0 + th, px0:px0 + tw])
            oy, ox = (sy - py0) * scale, (sx - px0) * scale
            out[:, :, sy * scale:ey * scale, sx * scale:ex * scale] = up[
                :, :, oy:oy + (ey - sy) * scale, ox:ox + (ex - sx) * scale]
    return out


def rrdbnet_arch(state_dict, scale: int = 4, num_out_ch: int = 3) -> RRDBNet:
    """The RRDBNet geometry of a checkpoint's state_dict (s2v_tpu's
    ``rrdbnet_arch``): num_feat, num_block and num_grow_ch. ``scale`` is the
    caller's (x2 and x4 checkpoints differ in their first conv's input
    only). Without those keys, the defaults, whose strict load then names
    them."""
    try:
        return RRDBNet(num_out_ch=num_out_ch, scale=scale,
                       num_feat=int(state_dict["conv_first.weight"].shape[0]),
                       num_block=len({k.split(".")[1] for k in state_dict
                                      if k.startswith("body.")}),
                       num_grow_ch=int(state_dict["body.0.rdb1.conv1.weight"].shape[0]))
    except KeyError:
        return RRDBNet(scale=scale, num_out_ch=num_out_ch)
