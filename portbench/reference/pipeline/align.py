"""Face alignment geometry (reference: futils/ffhq_preprocess.py and
futils/alignment_stit.py): the FFHQ oriented quad from 68 landmarks, the
Step-1 FFHQ crop box and the quad's crop adjustment, and the PIL QUAD and
PERSPECTIVE resamplings as sampling grids. The geometry is a handful of
floats per frame, so numpy (float64); the batched grids are built on the
quads' device, and the resampling is ``grid_sample`` on NCHW images."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.reference.ops.warp import grid_sample_bilinear


def compute_transform(lm: np.ndarray, scale: float = 1.0):
    """68-landmark FFHQ oriented rectangle (alignment_stit.py:116-146).
    Returns (c, x, y)."""
    eye_left = np.mean(lm[36:42], axis=0)
    eye_right = np.mean(lm[42:48], axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    x *= scale
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return c, x, y


def quad_from_cxy(c, x, y) -> np.ndarray:
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y])


def ffhq_crop_box(lm: np.ndarray, image_size: Tuple[int, int], output_size: int = 512):
    """First-frame FFHQ crop (ffhq_preprocess.py:57-116 align_face, shrink
    branch omitted as in s2v_tpu). Returns (crop, quad): crop = (clx, cly,
    crx, cry) ints and quad = [lx, ly, rx, ry] floats, the values the
    pipeline combines into the crop coordinates (facing.py)."""
    w, h = image_size
    c, x, y = compute_transform(lm)
    quad = quad_from_cxy(c, x, y)
    qsize = np.hypot(*x) * 2
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        quad -= crop[0:2]
    q = (quad + 0.5).flatten()
    lx = max(min(q[0], q[2]), 0)
    ly = max(min(q[1], q[7]), 0)
    rx = min(max(q[4], q[6]), w)
    ry = min(max(q[3], q[5]), w)  # the reference bounds y by img.size[0] too
    return crop, [lx, ly, rx, ry]


def crop_quad_params(quad: np.ndarray, image_size: Tuple[int, int],
                     output_size: int):
    """crop_image's crop + quad adjustment (alignment_stit.py:68-114, padding
    disabled). Returns (crop_box, adjusted_quad); the resample maps the
    adjusted quad (+0.5) in the cropped image to the output square."""
    w, h = image_size
    quad = quad.copy()
    x = (quad[3] - quad[1]) / 2
    qsize = np.hypot(*x) * 2
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        quad -= crop[0:2]
    else:
        crop = (0, 0, w, h)
    return crop, quad + 0.5


def _normalized(sx, sy, src_hw):
    """Source pixel coordinates -> grid_sample's normalized (x, y)
    (align_corners=False)."""
    h, w = src_hw
    return 2.0 * sx / w - 1.0, 2.0 * sy / h - 1.0


def quad_sample_grid(quad: np.ndarray, out_size: int, src_hw: Tuple[int, int]) -> np.ndarray:
    """Sampling grid of PIL ``Image.transform(QUAD)``: output (x, y) samples
    the source at the bilinear interpolation of the quad's corners (nw, sw,
    se, ne, PIL's order). Returns [out, out, 2] f32 normalized grid."""
    nw, sw, se, ne = quad[0], quad[1], quad[2], quad[3]
    t = (np.arange(out_size) + 0.5) / out_size  # pixel centres in [0, 1]
    tx, ty = t[None, :, None], t[:, None, None]  # along width, along height
    top = nw[None, None, :] + tx * (ne - nw)[None, None, :]
    bot = sw[None, None, :] + tx * (se - sw)[None, None, :]
    src = top + ty * (bot - top)  # [out, out, 2] source pixel coordinates
    return np.stack(_normalized(src[..., 0], src[..., 1], src_hw), axis=-1).astype(np.float32)


def calc_alignment_coefficients(pa, pb) -> np.ndarray:
    """8-parameter perspective solve mapping pb -> pa (alignment_stit.py:
    199-209): PIL's ``transform(size, PERSPECTIVE, coeffs)`` samples the
    source at ((a x + b y + c) / (g x + h y + 1), (d x + e y + f) / (...))
    for each output (x, y)."""
    matrix = []
    for p1, p2 in zip(pa, pb):
        matrix.append([p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]])
        matrix.append([0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0], -p2[1] * p1[1]])
    a = np.asarray(matrix, dtype=np.float64)
    b = np.asarray(pb, dtype=np.float64).reshape(8)
    return np.linalg.solve(a.T @ a, a.T @ b).reshape(8)


def perspective_sample_grid(coeffs: np.ndarray, out_hw: Tuple[int, int],
                            src_hw: Tuple[int, int]) -> np.ndarray:
    """Sampling grid of PIL ``Image.transform(PERSPECTIVE, coeffs)``, which
    evaluates the transform at output pixel centres. Returns [oh, ow, 2] f32
    normalized grid."""
    a, b, c, d, e, f, g, h = [float(v) for v in coeffs]
    oh, ow = out_hw
    xs = np.arange(ow, dtype=np.float64)[None, :] + 0.5
    ys = np.arange(oh, dtype=np.float64)[:, None] + 0.5
    denom = g * xs + h * ys + 1.0
    gx, gy = _normalized((a * xs + b * ys + c) / denom, (d * xs + e * ys + f) / denom, src_hw)
    return np.stack(np.broadcast_arrays(gx, gy), axis=-1).astype(np.float32)


def quad_grids_batched(quads, out_size: int, src_hw: Tuple[int, int]) -> torch.Tensor:
    """Batched ``quad_sample_grid`` on the quads' device: quads [N, 4, 2]
    (nw, sw, se, ne in source pixel coordinates) -> [N, out, out, 2] f32
    normalized grids. Eight floats a frame reach the device, not a grid."""
    q = torch.as_tensor(quads, dtype=torch.float32)
    nw, sw, se, ne = (q[:, i, None, None, :] for i in range(4))
    t = (torch.arange(out_size, dtype=torch.float32, device=q.device) + 0.5) / out_size
    tx, ty = t[None, None, :, None], t[None, :, None, None]  # along width, along height
    top = nw + tx * (ne - nw)
    bot = sw + tx * (se - sw)
    src = top + ty * (bot - top)  # [N, out, out, 2] source pixel coordinates
    return torch.stack(_normalized(src[..., 0], src[..., 1], src_hw), dim=-1)


def perspective_grids_batched(coeffs, out_hw: Tuple[int, int],
                              src_hw: Tuple[int, int]) -> torch.Tensor:
    """Batched ``perspective_sample_grid`` on the coefficients' device:
    coeffs [N, 8] -> [N, oh, ow, 2] f32 normalized grids."""
    cf = torch.as_tensor(coeffs, dtype=torch.float32)
    a, b, c, d, e, f, g, h = (cf[:, i, None, None] for i in range(8))
    oh, ow = out_hw
    xs = torch.arange(ow, dtype=torch.float32, device=cf.device)[None, None, :] + 0.5
    ys = torch.arange(oh, dtype=torch.float32, device=cf.device)[None, :, None] + 0.5
    denom = g * xs + h * ys + 1.0
    gx, gy = _normalized((a * xs + b * ys + c) / denom, (d * xs + e * ys + f) / denom, src_hw)
    return torch.stack([gx, gy], dim=-1)


def warp_by_grid(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Batched bilinear resample: images [B, C, H, W], grid [B, Ho, Wo, 2]
    or [Ho, Wo, 2] (the same for every image). Samples outside the source
    are zero (PIL fills 0)."""
    grid = torch.as_tensor(grid, device=images.device)
    if grid.dim() == 3:
        grid = grid.expand(images.shape[0], *grid.shape)
    return grid_sample_bilinear(images, grid)


def paste_back(projected: torch.Tensor, mask: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """paste_image (alignment_stit.py:14-18): alpha-composite the projected
    crop over the original with its in-bounds mask."""
    return projected * mask + orig * (1.0 - mask)
