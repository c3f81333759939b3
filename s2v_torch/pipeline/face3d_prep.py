"""3DMM preprocessing on the host (reference:
third_part/face3d/util/preprocess.py and util/load_mats.py): the POS
similarity solve, the 5-point extraction, ``align_img``, the BFM
5-point landmarks, and the Umeyama similarity with ``estimate_norm``'s
alignment to the ArcFace template.

``align_img`` resizes with Pillow's ``Image.resize(BICUBIC)`` and crops
with ``Image.crop`` in the reference. Pillow is not a dependency of the
port, so both are rebuilt here in numpy, bit for bit (Pillow's
libImaging/Resample.c, 8 bits per channel): a separable bicubic (a = -0.5)
whose support widens by the scale when downsampling, weights normalised in
double and rounded to 22 fractional bits, the horizontal pass first with
its uint8 intermediate, each pass skipped when its size is unchanged; the
crop fills with zeros past the image edge. Each frame gets its own output
size, so this stays on the host, one frame at a time.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_PRECISION_BITS = 22  # Resample.c: 32 - 8 bits of the pixel - 2 of headroom


def POS(xp: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Least-squares 3D->2D similarity (preprocess.py:18-40).

    xp: [2, N] image points; x: [3, N] canonical 3D points.
    Returns (t [2], s scalar).
    """
    npts = xp.shape[1]
    a = np.zeros([2 * npts, 8])
    a[0 : 2 * npts - 1 : 2, 0:3] = x.T
    a[0 : 2 * npts - 1 : 2, 3] = 1
    a[1 : 2 * npts : 2, 4:7] = x.T
    a[1 : 2 * npts : 2, 7] = 1
    b = np.reshape(xp.T, [2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(a, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.array([float(k[3][0]), float(k[7][0])])
    return t, float(s)


def extract_5p(lm: np.ndarray) -> np.ndarray:
    """68 -> 5 landmarks (preprocess.py:161-166): eyes, nose, mouth corners."""
    lm_idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5p = np.stack([lm[lm_idx[0]], np.mean(lm[lm_idx[[1, 2]]], 0),
                     np.mean(lm[lm_idx[[3, 4]]], 0), lm[lm_idx[5]], lm[lm_idx[6]]], axis=0)
    return lm5p[[1, 2, 0, 3, 4]]


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c bicubic_filter, a = -0.5, in double."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_coeffs(in_size: int, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for the full
    box: per output, the first input tap [out] and the fixed-point weights
    [out, ksize] (zero past the tap count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # the bicubic support, widened when downsampling
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None]
    valid = taps < count[:, None]
    ss = 1.0 / filterscale
    w = np.where(valid, _bicubic((taps + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # the C loop's summation order
        ww += w[:, t]
    w = np.where((ww != 0.0)[:, None], w / np.where(ww != 0.0, ww, 1.0)[:, None], w)
    one = float(1 << _PRECISION_BITS)
    kint = np.where(w < 0, -0.5 + w * one, 0.5 + w * one).astype(np.int64)
    return xmin, kint


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Resample.c along ``axis`` (0 rows, 1 columns) of
    an [H, W, C] uint8 image: int32 sums over the taps (as the C code's),
    rounded with half of the last bit, clipped to uint8."""
    in_size = img.shape[axis]
    xmin, kint = _resample_coeffs(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = None
    for t in range(kint.shape[1]):  # zero weights past each output's tap count
        term = (np.take(img, np.minimum(xmin + t, in_size - 1), axis=axis).astype(np.int32)
                * kint[:, t].astype(np.int32).reshape(shape))
        acc = term if acc is None else acc + term
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BICUBIC)`` for an
    [H, W, C] uint8 image; ``size`` is (width, height) as Pillow takes it."""
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size}: height and width must be > 0")
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return img.copy() if out is img else out


def crop_zero(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """``Image.crop((left, upper, right, lower))``: pixels past the image
    edge are zero."""
    left, up, right, below = box
    out = np.zeros((below - up, right - left) + img.shape[2:], img.dtype)
    y0, y1 = max(up, 0), min(below, img.shape[0])
    x0, x1 = max(left, 0), min(right, img.shape[1])
    if y1 > y0 and x1 > x0:
        out[y0 - up:y1 - up, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def align_img(img: np.ndarray, lm: np.ndarray, lm3d: np.ndarray,
              target_size: float = 224.0, rescale_factor: float = 102.0):
    """preprocess.py:169-190: POS solve -> bicubic resize -> centre crop.

    img [H, W, 3] uint8; lm [68, 2] (or [5, 2]) with y pointing up, as the
    pipeline hands them over; lm3d [5, 3]. Returns (trans_params
    [w0, h0, s, tx, ty] f32, the aligned [224, 224, 3] uint8 image, the
    landmarks in it).
    """
    h0, w0 = img.shape[:2]
    lm5p = extract_5p(lm) if lm.shape[0] != 5 else lm
    t, s = POS(lm5p.T, lm3d.T)
    s = rescale_factor / s

    w = int(w0 * s)
    h = int(h0 * s)
    left = int(w / 2 - target_size / 2 + (t[0] - w0 / 2) * s)
    right = left + int(target_size)
    up = int(h / 2 - target_size / 2 + (h0 / 2 - t[1]) * s)
    below = up + int(target_size)

    img_new = crop_zero(resize_bicubic_u8(img, (w, h)), (left, up, right, below))
    lm_new = np.stack([lm[:, 0] - t[0] + w0 / 2, lm[:, 1] - t[1] + h0 / 2], axis=1) * s
    lm_new = lm_new - np.array([[w / 2 - target_size / 2, h / 2 - target_size / 2]])

    trans_params = np.array([w0, h0, s, t[0], t[1]], dtype=np.float32)
    return trans_params, img_new, lm_new


def umeyama(src: np.ndarray, dst: np.ndarray, estimate_scale: bool = True) -> np.ndarray:
    """Least-squares similarity transform (Umeyama 1991; skimage's
    ``SimilarityTransform.estimate``, GPEN align_faces.py:25). src, dst
    [N, 2]. Returns the 3x3 homogeneous matrix mapping src to dst (NaNs
    when ``dst - mean`` against ``src - mean`` has rank 0)."""
    num, dim = src.shape
    src_mean, dst_mean = src.mean(axis=0), dst.mean(axis=0)
    src_d, dst_d = src - src_mean, dst - dst_mean
    a = dst_d.T @ src_d / num
    d = np.ones((dim,))
    if np.linalg.det(a) < 0:
        d[dim - 1] = -1
    t = np.eye(dim + 1)
    u, s, v = np.linalg.svd(a)
    rank = np.linalg.matrix_rank(a)
    if rank == 0:
        return t * np.nan
    if rank == dim - 1 and np.linalg.det(u) * np.linalg.det(v) <= 0:
        d_last = d[dim - 1]
        d[dim - 1] = -1
        t[:dim, :dim] = u @ np.diag(d) @ v
        d[dim - 1] = d_last
    elif rank == dim - 1:
        t[:dim, :dim] = u @ v
    else:
        t[:dim, :dim] = u @ np.diag(d) @ v
    scale = 1.0 / src_d.var(axis=0).sum() * (s @ d) if estimate_scale else 1.0
    t[:dim, dim] = dst_mean - scale * (t[:dim, :dim] @ src_mean)
    t[:dim, :dim] *= scale
    return t


# insightface's 112x112 template (preprocess.py:196-227 estimate_norm)
ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]],
    dtype=np.float32,
)


def estimate_norm(lm_68p: np.ndarray, height: float) -> np.ndarray:
    """preprocess.py:196-227: the 5-point similarity to the ArcFace template
    (y flipped to image coordinates; the identity where the solve fails).
    Returns the [2, 3] affine."""
    lm = extract_5p(lm_68p).copy()
    lm[:, -1] = height - 1 - lm[:, -1]
    m = umeyama(lm, ARCFACE_DST, True)
    if not np.isfinite(m).all() or np.linalg.det(m) == 0:
        m = np.eye(3)
    return m[0:2]


def load_lm3d(bfm_dir: str) -> np.ndarray:
    """Standard 5-point 3D landmarks (util/load_mats.py:105-117): loads
    ``similarity_Lm3D_all.mat``, picks the 5-point subset, reorders it.

    The BFM data files ship separately (like the reference's checkpoints/BFM).
    """
    import os

    from scipy.io import loadmat

    path = os.path.join(bfm_dir, "similarity_Lm3D_all.mat")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"BFM landmark file not found: {path}. Download the Basel Face "
            "Model data as in the reference README and point the checkpoint "
            "directory at it.")
    lm3d = loadmat(path)["lm"]
    lm_idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm3d = np.stack([lm3d[lm_idx[0]], np.mean(lm3d[lm_idx[[1, 2]]], 0),
                     np.mean(lm3d[lm_idx[[3, 4]]], 0), lm3d[lm_idx[5]], lm3d[lm_idx[6]]],
                    axis=0)
    return lm3d[[1, 2, 0, 3, 4], :]
