"""Batched warps on NCHW float tensors.

- ``grid_sample_bilinear``: ``F.grid_sample`` (bilinear, zeros padding,
  ``align_corners=False``), the semantics s2v_tpu's gather formulation
  reproduces.
- ``crop_resize_boxes`` / ``paste_resize_boxes``: per-frame box crop +
  bilinear resize and its inverse paste, as two batched matmuls against
  per-frame interpolation weights (zero weight outside the image).
- ``affine_warp``: batched ``cv2.warpAffine`` with bilinear sampling and a
  zero border, the grid built on the device from the 2x3 matrices.
- ``affine_warp_shear``: its approximation as two sheared separable passes
  (config ``model.approx_warp``), s2v_tpu's design: a row-granular window
  gather, a per-row residual shift and a banded interpolation matmul.
- ``convert_flow_to_deformation`` / ``warp_image``: DNet's flow warp
  (reference: futils/flow_util.py:3-56), a pixel-unit flow added to the
  identity grid, upsampled to the image and sampled with ``grid_sample``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.device import full_f32
from portbench.reference.ops.image import resize_bilinear


def grid_sample_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image [B, C, H, W]; grid [B, Hg, Wg, 2] of (x, y) in [-1, 1]."""
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def make_coordinate_grid(h: int, w: int, device=None) -> torch.Tensor:
    """[H, W, 2] grid of (x, y) in [-1, 1] (flow_util.py:17-38)."""
    x = torch.linspace(-1.0, 1.0, w, device=device)
    y = torch.linspace(-1.0, 1.0, h, device=device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def convert_flow_to_deformation(flow: torch.Tensor) -> torch.Tensor:
    """Pixel-unit flow [B, 2, H, W] (dx, dy) -> normalised deformation grid
    [B, H, W, 2]: the flow scaled by 2 / (size - 1) per axis plus the
    identity grid (flow_util.py:3-15)."""
    _, _, h, w = flow.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=flow.dtype, device=flow.device)
    grid = make_coordinate_grid(h, w, flow.device).to(flow.dtype)
    return grid[None] + flow.permute(0, 2, 3, 1) * scale


def warp_image(source: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """Sample ``source`` [B, C, H, W] at ``deformation`` [B, Hd, Wd, 2],
    bilinearly upsampled to (H, W) first when it is smaller (DNet predicts
    its flow at 64^2 and warps 256^2, flow_util.py:41-56). The sample runs
    in f32; the result has the source's dtype."""
    h, w = source.shape[2:]
    grid = deformation.float()
    if tuple(grid.shape[1:3]) != (h, w):
        grid = resize_bilinear(grid.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
    return grid_sample_bilinear(source.float(), grid).to(source.dtype)


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


# Shear-resample row-group size and residual-shift tap count (s2v_tpu's
# defaults, which it reads from S2V_SHEAR_G / S2V_SHEAR_U for its probes;
# here they are constants). G rows share one window origin; U bounds the
# within-group source drift the residual shift absorbs: |shift| * (G - 1) <=
# U - 2, a shear of up to ~1.47.
_SHEAR_G = 16
_SHEAR_U = 24


def _shear_resample_rows(x: torch.Tensor, stride: torch.Tensor, shift: torch.Tensor,
                         const: torch.Tensor, out_s: int) -> torch.Tensor:
    """Per-row sheared 1-D resample along the last axis (s2v_tpu's
    ``_shear_resample_rows``). x [N, C, R, S]; out[n, c, r, t] = x[n, c, r,
    stride[n] * t + shift[n] * r + const[n]], interpolated. Each group of
    ``_SHEAR_G`` rows reads one window of the edge-replicated rows from an
    integer origin; a ``_SHEAR_U``-tap lerp shifts each row by its residual
    offset, and one matmul against shared-stride interpolation weights
    resamples. Valid for stride > 0 and |shift| <= (U - 2) / (G - 1); the
    caller zeroes outputs outside the source."""
    n, c, r, s = x.shape
    g, u = _SHEAR_G, _SHEAR_U
    rp = -(-r // g) * g  # rows padded to a multiple of G
    if rp != r:
        x = F.pad(x, (0, 0, 0, rp - r))
    kx = 2 * s + 1  # lerped window offsets in [0, 2s] reach every in-bounds source
    kg = kx + u     # plus the residual shift and its lerp's extra tap
    dev = x.device
    rows = torch.arange(rp, dtype=torch.float32, device=dev)
    pos = shift[:, None] * rows[None] + const[:, None]  # [N, Rp]
    pg = pos.reshape(n, rp // g, g)
    base = torch.clamp(torch.floor(pg.amin(dim=2)), -float(s), float(s))  # [N, Gc]
    resid = torch.clamp(pg - base[..., None], 0.0, u - 2 + 0.999)
    ri = torch.floor(resid)
    rf = (resid - ri).reshape(n, rp)
    ri = ri.reshape(n, rp)
    # edge-replicated padding (s on the left, kg on the right): an origin
    # slightly out of bounds must not bleed zeros into in-bounds samples
    cols = torch.clamp(torch.arange(-s, s + kg, device=dev), 0, s - 1)
    windows = x[..., cols].unfold(3, kg, 1)  # [N, C, Rp, 2s + 1, kg], a view
    start = (base.long() + s).repeat_interleave(g, dim=1)  # [N, Rp], in [0, 2s]
    win = windows[torch.arange(n, device=dev)[:, None], :,
                  torch.arange(rp, device=dev)[None], start]  # [N, Rp, C, kg]
    win = win.permute(0, 2, 1, 3)
    # the residual shift: weight (1 - rf) at tap ri, rf at tap ri + 1
    taps = torch.arange(u, dtype=torch.float32, device=dev)
    wu = ((taps == ri[..., None]) * (1.0 - rf)[..., None]
          + (taps == (ri + 1.0)[..., None]) * rf[..., None])[:, None]  # [N, 1, Rp, U]
    acc = wu[..., 0, None] * win[..., 0:kx]
    for k in range(1, u):
        acc = acc + wu[..., k, None] * win[..., k:k + kx]
    ts = torch.arange(out_s, dtype=torch.float32, device=dev)
    wx = _interp_weights(stride[:, None] * ts[None], kx)  # [N, T, Kx]
    out = torch.einsum("ntx,ncrx->ncrt", wx, acc)
    return out[:, :, :r]


def affine_warp_shear(images: torch.Tensor, mats: torch.Tensor, out_hw,
                      inverse: bool = False) -> torch.Tensor:
    """``affine_warp`` approximated as two sheared separable passes
    (s2v_tpu's ``affine_warp_shear``, config ``model.approx_warp``).

    The destination -> source affine [[a, b, tx], [c, d, ty]] factors
    (Catmull-Smith) into a horizontal pass x' = (a - b c / d) j + (b / d) y
    + const over source rows, then a vertical pass y' = c j + d i + ty over
    columns, each ``_shear_resample_rows``. Each pass interpolates with a
    lerp of lerps, a 3-tap kernel per axis whose weights sum to 1 with its
    first moment at the sample: exact on linear content, slightly smoother
    than bilinear on curvature. Valid for d > 0, a - b c / d > 0, shears
    |b / d|, |c| up to ~1.4 (similarities with |rotation| up to ~55 deg)
    and an output whose first column (row) maps no further than the
    source's width (height) outside it: the window origins clip there, and
    past it the result is no approximation, in s2v_tpu's as here.
    Outputs outside the source footprint are zero (cv2's BORDER_CONSTANT);
    the border ring may differ from ``affine_warp`` by one tap. Arithmetic in
    full f32 (TF32 would lose three digits of its matmuls). images [N, C,
    H, W]; mats [N, 2, 3] as ``affine_warp``'s. Returns f32 (uint8 input)
    or the input's dtype."""
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
    d_safe = torch.where(i11.abs() < 1e-6, torch.full_like(i11, 1e-6), i11)
    with full_f32():
        # pass 1: rows keep their y, columns resampled to output x
        mid = _shear_resample_rows(images.float(), i00 - i01 * i10 / d_safe, i01 / d_safe,
                                   i02 - i01 * i12 / d_safe, ow)  # [N, C, H, ow]
        # pass 2: per output column j, along y at i10 j + i11 i + i12
        out = _shear_resample_rows(mid.transpose(2, 3), i11, i10, i12, oh).transpose(2, 3)
    xs = torch.arange(ow, dtype=torch.float32, device=images.device)[None, None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=images.device)[None, :, None]

    def c(v):
        return v[:, None, None]

    sx = c(i00) * xs + c(i01) * ys + c(i02)
    sy = c(i10) * xs + c(i11) * ys + c(i12)
    inb = (sx > -1.0) & (sx < w) & (sy > -1.0) & (sy < h)
    out = torch.where(inb[:, None], out, torch.zeros((), device=out.device))
    return out.to(images.dtype if images.is_floating_point() else torch.float32)


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
