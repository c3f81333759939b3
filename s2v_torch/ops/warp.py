"""Batched warps on NCHW float tensors.

- ``grid_sample_bilinear``: ``F.grid_sample`` (bilinear, zeros padding,
  ``align_corners=False``), the semantics s2v_tpu's gather formulation
  reproduces.
- ``crop_resize_boxes`` / ``paste_resize_boxes``: per-frame box crop +
  bilinear resize and its inverse paste, as two batched matmuls against
  per-frame interpolation weights (zero weight outside the image).
- ``affine_warp``: batched ``cv2.warpAffine`` with bilinear sampling and a
  zero border, the grid built on the device from the 2x3 matrices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image [B, C, H, W]; grid [B, Hg, Wg, 2] of (x, y) in [-1, 1]."""
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _interp_weights(src: torch.Tensor, size: int) -> torch.Tensor:
    """[..., out] sample positions -> [..., out, size] bilinear weights;
    taps outside [0, size) get weight zero (grid_sample's zeros padding)."""
    i0 = torch.floor(src)
    f = src - i0
    cols = torch.arange(size, dtype=src.dtype, device=src.device)
    w0 = (cols == i0[..., None]).to(src.dtype) * (1.0 - f)[..., None]
    w1 = (cols == (i0 + 1.0)[..., None]).to(src.dtype) * f[..., None]
    return w0 + w1


def _resample_separable(images: torch.Tensor, sy: torch.Tensor,
                        sx: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bilinear resample: images [N, C, H, W]; sy [N, oh] and
    sx [N, ow] per-frame source positions in pixels."""
    wy = _interp_weights(sy.float(), images.shape[2])  # [N, oh, H]
    wx = _interp_weights(sx.float(), images.shape[3])  # [N, ow, W]
    x = torch.einsum("nyh,nchw->ncyw", wy, images.float())
    return torch.einsum("nxw,ncyw->ncyx", wx, x)


def crop_resize_boxes(images: torch.Tensor, boxes: torch.Tensor,
                      out_hw) -> torch.Tensor:
    """Crop each frame to its box (x1, y1, x2, y2) and resize to ``out_hw``
    with half-pixel centres. images [N, C, H, W] -> [N, C, oh, ow] f32."""
    oh, ow = out_hw
    boxes = boxes.float()
    dev = images.device
    x1, y1, x2, y2 = boxes[:, 0:1], boxes[:, 1:2], boxes[:, 2:3], boxes[:, 3:4]
    tx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    ty = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    sx = x1 + tx[None] * (x2 - x1) - 0.5
    sy = y1 + ty[None] * (y2 - y1) - 0.5
    return _resample_separable(images, sy, sx)


def affine_warp(images: torch.Tensor, mats: torch.Tensor, out_hw,
                inverse: bool = False) -> torch.Tensor:
    """Batched ``cv2.warpAffine(src, M, dsize)``, bilinear, zero border.

    images [N, C, H, W]; mats [N, 2, 3] map source to destination pixels
    (inverted here) or, with ``inverse=True``, destination to source.
    """
    n, _, h, w = images.shape
    oh, ow = out_hw
    m = mats.float()
    a00, a01, a02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    a10, a11, a12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    if not inverse:
        det = a00 * a11 - a01 * a10
        i00, i01 = a11 / det, -a01 / det
        i10, i11 = -a10 / det, a00 / det
        i02 = -(i00 * a02 + i01 * a12)
        i12 = -(i10 * a02 + i11 * a12)
    else:
        i00, i01, i02, i10, i11, i12 = a00, a01, a02, a10, a11, a12
    xs = torch.arange(ow, dtype=torch.float32, device=images.device)[None, None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=images.device)[None, :, None]

    def c(v):
        return v[:, None, None]

    sx = c(i00) * xs + c(i01) * ys + c(i02)
    sy = c(i10) * xs + c(i11) * ys + c(i12)
    gx = (2.0 * sx + 1.0) / w - 1.0
    gy = (2.0 * sy + 1.0) / h - 1.0
    return grid_sample_bilinear(images.float(), torch.stack([gx, gy], dim=-1))


def paste_resize_boxes(frames: torch.Tensor, preds: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """Inverse of ``crop_resize_boxes``: resize each pred [N, C, s, s] to its
    integer box and paste it into its frame [N, C, H, W]; pixels outside the
    box keep the frame. Half-pixel centres with edge clamping."""
    n, c, h, w = frames.shape
    s = preds.shape[2]
    boxes = boxes.float()
    dev = frames.device
    x1, y1, x2, y2 = boxes[:, 0:1], boxes[:, 1:2], boxes[:, 2:3], boxes[:, 3:4]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None] + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None] + 0.5
    u = torch.clamp((xs - x1) / torch.clamp(x2 - x1, min=1.0) * s - 0.5, 0.0, s - 1.0)
    v = torch.clamp((ys - y1) / torch.clamp(y2 - y1, min=1.0) * s - 0.5, 0.0, s - 1.0)
    warped = _resample_separable(preds, v, u)
    in_x = (xs - 0.5 >= x1) & (xs - 0.5 < x2)  # [N, W]
    in_y = (ys - 0.5 >= y1) & (ys - 0.5 < y2)  # [N, H]
    mask = (in_y[:, :, None] & in_x[:, None, :])[:, None]
    return torch.where(mask, warped, frames.float())
