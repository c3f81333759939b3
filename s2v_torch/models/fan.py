"""FAN 68-landmark network and its crop and decode (reference:
third_part/face_detection/models.py and utils.py, the ``face_alignment``
package behind face3d's KeypointExtractor), NCHW.

- ``FAN``: the stacked hourglass (2DFAN4: 4 modules, 256 features) with the
  reference's module names (``2DFAN4.pth`` loads as it is); returns the last
  module's 64x64 heatmaps.
- ``crop_faces_batched``: utils.py crop() (zero padding + bilinear resize)
  for a batch, as two interpolation matmuls.
- ``heatmaps_to_landmarks``: get_preds_fromhm (argmax, +-0.25 toward the
  larger neighbour, -0.5, inverse centre/scale transform) over the batch.
- ``lm68_to_lm5``: the 5-point template order the enhancers align with.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.ops.image import avg_pool_2x2, resize_nearest
from s2v_torch.ops.warp import _resample_separable


class ConvBlock(nn.Module):
    """models.py:13-55: pre-activation 3-branch block with dense concat; a
    BN-ReLU-1x1 downsample on the residual when the width changes."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, half, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(half)
        self.conv2 = nn.Conv2d(half, quarter, 3, 1, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, 1, 1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(nn.BatchNorm2d(in_planes), nn.ReLU(),
                                            nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], 1) + residual


class HourGlass(nn.Module):
    """models.py:97-140: recursive hourglass of ``depth`` levels."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lvl in range(depth, 0, -1):
            setattr(self, f"b1_{lvl}", ConvBlock(features, features))
            setattr(self, f"b2_{lvl}", ConvBlock(features, features))
            if lvl == 1:
                self.b2_plus_1 = ConvBlock(features, features)
            setattr(self, f"b3_{lvl}", ConvBlock(features, features))

    def _level(self, x, lvl: int):
        up1 = getattr(self, f"b1_{lvl}")(x)
        low1 = getattr(self, f"b2_{lvl}")(avg_pool_2x2(x))
        low2 = self._level(low1, lvl - 1) if lvl > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{lvl}")(low2)
        h, w = low3.shape[-2:]
        return up1 + resize_nearest(low3, (2 * h, 2 * w))

    def forward(self, x):
        return self._level(x, self.depth)


class FAN(nn.Module):
    """models.py:143-196. Input [B, 3, 256, 256] RGB in [0, 1]; returns the
    last module's heatmaps [B, 68, 64, 64] (the reference uses outputs[-1])."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            setattr(self, f"m{i}", HourGlass())
            setattr(self, f"top_m_{i}", ConvBlock(256, 256))
            setattr(self, f"conv_last{i}", nn.Conv2d(256, 256, 1))
            setattr(self, f"bn_end{i}", nn.BatchNorm2d(256))
            setattr(self, f"l{i}", nn.Conv2d(256, 68, 1))
            if i < num_modules - 1:
                setattr(self, f"bl{i}", nn.Conv2d(256, 256, 1))
                setattr(self, f"al{i}", nn.Conv2d(68, 256, 1))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = avg_pool_2x2(self.conv2(x))
        previous = self.conv4(self.conv3(x))
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(out))
        return out


def box_to_center_scale(boxes: torch.Tensor, reference_scale: float = 195.0):
    """face_alignment convention: centre shifted up 12% of the box height,
    scale = (w + h) / 195. boxes [B, 4] x1y1x2y2 -> (centres [B, 2],
    scales [B])."""
    x1, y1, x2, y2 = boxes.unbind(dim=1)
    cy = (y1 + y2) / 2.0 - (y2 - y1) * 0.12
    return torch.stack([(x1 + x2) / 2.0, cy], dim=1), (x2 - x1 + y2 - y1) / reference_scale


def _crop_bounds(center: torch.Tensor, scale: torch.Tensor, resolution: float = 256.0):
    """utils.py crop(): ul = T^-1([1, 1]), br = T^-1([res + 1, res + 1]) with
    h = 200 * scale, truncated to int like torch's ``.int()``."""
    h = 200.0 * scale

    def invt(p):
        return torch.stack([p * h / resolution + center[:, 0] - h / 2.0,
                            p * h / resolution + center[:, 1] - h / 2.0], 1)

    return invt(1.0).to(torch.int32), invt(resolution + 1.0).to(torch.int32)


def crop_faces_batched(images: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                       resolution: int = 256) -> torch.Tensor:
    """FAN's pre-crop: images [B, 3, H, W] 0..255 -> [B, 3, res, res] in
    [0, 1], zero outside the image (utils.py crop(): zero pad +
    cv2.INTER_LINEAR resize, which samples at (j + 0.5) * src / dst - 0.5)."""
    ul, br = _crop_bounds(centers, scales, float(resolution))
    t = (torch.arange(resolution, dtype=torch.float32, device=images.device) + 0.5) / resolution
    sw = (br[:, 0] - ul[:, 0]).float()
    sh = (br[:, 1] - ul[:, 1]).float()
    sx = ul[:, 0, None].float() + t[None] * sw[:, None] - 0.5
    sy = ul[:, 1, None].float() + t[None] * sh[:, None] - 0.5
    return _resample_separable(images.float(), sy, sx) / 255.0


def heatmaps_to_landmarks(hm: torch.Tensor, centers: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """[B, 68, 64, 64] heatmaps -> [B, 68, 2] landmarks in image pixels
    (utils.py:132-163): the argmax, +-0.25 toward the larger neighbour on
    strictly interior peaks, +0.5 (1-indexed then -0.5), then
    x_img = x_hm * h / 64 + c - h / 2 with h = 200 * scale (utils.py:56-96)."""
    b, n, hh, ww = hm.shape
    flat = hm.float().reshape(b, n, hh * ww)
    idx = torch.argmax(flat, dim=2)
    pxi, pyi = idx % ww, torch.div(idx, ww, rounding_mode="floor")

    def at(dy, dx):
        yy = torch.clamp(pyi + dy, 0, hh - 1)
        xx = torch.clamp(pxi + dx, 0, ww - 1)
        return torch.gather(flat, 2, (yy * ww + xx)[..., None])[..., 0]

    interior = (pxi > 0) & (pxi < ww - 1) & (pyi > 0) & (pyi < hh - 1)
    zero = torch.zeros((), device=hm.device)
    px = pxi.float() + torch.where(interior, torch.sign(at(0, 1) - at(0, -1)) * 0.25, zero)
    py = pyi.float() + torch.where(interior, torch.sign(at(1, 0) - at(-1, 0)) * 0.25, zero)
    px, py = px + 0.5, py + 0.5
    h = 200.0 * scales
    x_img = px * (h / hh)[:, None] + centers[:, 0:1] - (h / 2.0)[:, None]
    y_img = py * (h / hh)[:, None] + centers[:, 1:2] - (h / 2.0)[:, None]
    return torch.stack([x_img, y_img], dim=-1)


def lm68_to_lm5(lm68: np.ndarray) -> np.ndarray:
    """[..., 68, 2] -> [..., 5, 2] in the RetinaFace / arcface template order
    (left eye, right eye, nose tip, left mouth corner, right mouth corner):
    eye = centroid of its 6-point contour, nose = point 30, mouth corners =
    points 48 and 54."""
    lm68 = np.asarray(lm68)
    return np.stack([lm68[..., 36:42, :].mean(axis=-2),
                     lm68[..., 42:48, :].mean(axis=-2),
                     lm68[..., 30, :], lm68[..., 48, :], lm68[..., 54, :]],
                    axis=-2)
