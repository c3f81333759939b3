"""Pipeline helpers (reference: futils/inference_utils.py).

- 3DMM coefficient windows (inference_utils.py:73-99): ``split_coeff``,
  ``transform_semantic`` (DNet's driving input for every frame at once,
  over edge-clamped windows: ``gather_windows``, from the port's
  ``parallel/halo.py``)
  and ``find_crop_norm_ratio``.
- OpenCV-convention mask helpers of GPEN's enhancer (inference_utils.py:
  59-64), NCHW: ``gaussian_blur`` is cv2.GaussianBlur(ksize, sigma) with a
  REFLECT_101 border, run as two banded-matrix matmuls (the border folded
  into the matrices); ``mask_postprocess`` zeroes a border and blurs twice
  with (101, sigma 11).
- OpenCV's pyramids, NCHW: ``pyr_down`` / ``pyr_up`` are cv2.pyrDown /
  pyrUp (the 5-tap [1, 4, 6, 4, 1] / 16 filter on both axes, REFLECT_101
  border; even rows and columns kept, or zero-stuffed and filtered with gain
  4), each axis one matmul against a matrix with the border and the
  decimation or stuffing folded in; ``laplacian_pyramid_blend`` is
  Laplacian_Pyramid_Blending_with_mask
  (inference_utils.py:181-222), the Step-6 mouth blend and the enhancer's
  ``possion_blending`` composite.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch


def window_offsets(window: int) -> np.ndarray:
    """Frame offsets of a temporal window: obtain_seq_index
    (inference_utils.py:73-76) is ``range(i - 13, i + 13)``, offsets
    ``arange(window) - window // 2`` (asymmetric for even windows)."""
    return np.arange(window) - window // 2


def gather_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[N, ...] -> [N, window, ...], indices clamped to [0, N - 1] as
    obtain_seq_index clips them."""
    n = x.shape[0]
    idx = np.clip(np.arange(n)[:, None] + window_offsets(window)[None], 0, n - 1)
    return x[torch.as_tensor(idx, device=x.device)]


def split_coeff(coeffs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, 257] ReconNet output -> named groups (inference_utils.py:158-179)."""
    return {"id": coeffs[:, :80], "exp": coeffs[:, 80:144], "tex": coeffs[:, 144:224],
            "angle": coeffs[:, 224:227], "gamma": coeffs[:, 227:254], "trans": coeffs[:, 254:]}


def transform_semantic(semantic: torch.Tensor, crop_norm_ratio: Optional[torch.Tensor] = None,
                       window: int = 26) -> torch.Tensor:
    """[N, 262] per-frame coefficients (257 + 5 alignment params) ->
    [N, 73, window] (inference_utils.py:78-91): exp(64) | angles(3) |
    translation(3) | crop(3), the crop scale times ``crop_norm_ratio``."""
    windows = gather_windows(semantic, window)  # [N, window, 262]
    crop = windows[..., 259:262]
    if crop_norm_ratio is not None:
        crop = torch.cat([crop[..., :1] * crop_norm_ratio.reshape(-1, 1, 1), crop[..., 1:]], -1)
    out = torch.cat([windows[..., 80:144], windows[..., 224:227], windows[..., 254:257], crop],
                    -1)
    return out.permute(0, 2, 1)


def find_crop_norm_ratio(source_coeff: torch.Tensor, target_coeffs: torch.Tensor):
    """inference_utils.py:93-99: ratio of the crop scales at the target frame
    most like the source in expression and pose."""
    alpha = 0.3
    exp_diff = (target_coeffs[:, 80:144] - source_coeff[:, 80:144]).abs().mean(dim=1)
    angle_diff = (target_coeffs[:, 224:227] - source_coeff[:, 224:227]).abs().mean(dim=1)
    index = torch.argmin(alpha * exp_diff + (1 - alpha) * angle_diff)
    return source_coeff[:, -3] / target_coeffs[index, -3]


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma)."""
    n = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(n ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, ksize: int, sigma: float) -> np.ndarray:
    """[size, size] M with (M @ v)[i] == GaussianBlur1d(v)[i], REFLECT_101."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    m = np.zeros((size, size), np.float32)
    for t, kt in enumerate(k):
        for i in range(size):
            j = i + t - pad
            while j < 0 or j >= size:
                j = -j if j < 0 else 2 * (size - 1) - j
            m[i, j] += kt
    return m


@functools.lru_cache(maxsize=None)
def _blur_matrix_on(size: int, ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    """``_blur_matrix`` on ``device``, copied there once: a copy of a
    matrix (1 MB at 512) from pageable memory at every call would make the
    host wait for the card's queue."""
    return torch.from_numpy(_blur_matrix(size, ksize, sigma)).to(device)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """x [B, C, H, W] f32: vertical pass, then horizontal (cv2's order)."""
    h, w = x.shape[-2:]
    mv = _blur_matrix_on(h, ksize, sigma, x.device)
    mh = _blur_matrix_on(w, ksize, sigma, x.device)
    x = torch.einsum("ih,bchw->bciw", mv, x)
    return torch.einsum("jw,bchw->bchj", mh, x)


def mask_postprocess(mask: torch.Tensor, thres: int = 20) -> torch.Tensor:
    """mask [B, 1, H, W]: zero a ``thres`` border, then blur twice with
    GaussianBlur(101, 11)."""
    h, w = mask.shape[-2:]
    m = torch.zeros_like(mask)
    m[..., thres:h - thres, thres:w - thres] = mask[..., thres:h - thres, thres:w - thres]
    return gaussian_blur(gaussian_blur(m, 101, 11.0), 101, 11.0)


_PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source indices of an axis of ``n`` padded by ``pad`` on each side with
    REFLECT_101, as numpy's and jnp.pad's ``mode="reflect"`` build them:
    when ``pad`` exceeds ``n - 1`` the reflection repeats (a 2-element axis
    padded by 2 reads 0 1 0 1 0 1, a 1-element axis repeats its value),
    which the pyramids' 2x2 and 1x1 levels need and F.pad refuses."""
    if n == 1:
        return np.zeros(n + 2 * pad, np.int64)
    j = np.abs(np.arange(-pad, n + pad)) % (2 * (n - 1))
    return np.where(j >= n, 2 * (n - 1) - j, j)


@functools.lru_cache(maxsize=None)
def _pyr_matrix(n: int, up: bool) -> np.ndarray:
    """One axis of cv2.pyrDown (``up`` False: [ceil(n / 2), n], the 5-tap
    filter's even outputs) or of cv2.pyrUp (``up``: [2n, n], the filter
    times 2 over the zero-stuffed axis; the two axes make pyrUp's gain of
    4) as a matrix, with the REFLECT_101 border folded in."""
    size = 2 * n if up else n
    src = _reflect_index(size, 2)  # padded position -> source index
    rows = 2 * n if up else (n + 1) // 2
    m = np.zeros((rows, n), np.float64)
    for i in range(rows):
        centre = i if up else 2 * i
        for t, k in enumerate(_PYR_TAPS):
            j = src[centre + t]
            if not up:
                m[i, j] += k
            elif j % 2 == 0:  # the stuffed zeros add nothing
                m[i, j // 2] += 2.0 * k
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pyr_matrix_on(n: int, up: bool, device: torch.device) -> torch.Tensor:
    """``_pyr_matrix`` on ``device``, copied there once (a pageable copy at
    every call would make the host wait for the card's queue)."""
    return torch.from_numpy(_pyr_matrix(n, up)).to(device)


def _pyr(x: torch.Tensor, up: bool) -> torch.Tensor:
    """Both axes of [B, C, H, W] through ``_pyr_matrix``: two matmuls, f32
    (cuBLAS keeps f32 unless TF32 is allowed for matmuls, which PyTorch
    does not by default)."""
    h, w = x.shape[-2:]
    x = torch.matmul(_pyr_matrix_on(h, up, x.device), x)
    return torch.matmul(x, _pyr_matrix_on(w, up, x.device).t())


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown on [B, C, H, W]: blur, keep the even rows and columns ->
    [B, C, ceil(H / 2), ceil(W / 2)]."""
    return _pyr(x, up=False)


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrUp on [B, C, H, W]: zero-stuff to [B, C, 2H, 2W], then blur
    with the kernel times 4."""
    return _pyr(x, up=True)


def laplacian_pyramid_blend(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                            num_levels: int = 10) -> torch.Tensor:
    """Blend ``a`` over ``b`` [B, C, H, W] (0..255) by ``mask`` [B, 1, H, W]
    or [B, H, W] (0..1) through Laplacian pyramids.

    The reference's quirk is kept: the base is Gaussian level
    ``num_levels - 1`` and the levels run from there down to 1, so level
    ``num_levels``, which the reference computes and never reads, is left
    out."""
    if mask.dim() == 3:
        mask = mask[:, None]
    c = a.shape[1]

    def blend(ab, m):
        return ab[:, :c] * m + ab[:, c:2 * c] * (1.0 - m)

    # a, b and the mask share one Gaussian pyramid (the filter is per channel)
    gp = [torch.cat([a, b, mask], dim=1)]
    for _ in range(num_levels - 1):
        gp.append(pyr_down(gp[-1]))
    out = blend(gp[-1], gp[-1][:, 2 * c:])
    for i in range(num_levels - 1, 0, -1):
        lap = gp[i - 1][:, :2 * c] - pyr_up(gp[i][:, :2 * c])
        out = pyr_up(out) + blend(lap, gp[i - 1][:, 2 * c:])
    return out
