"""Pipeline helpers (reference: futils/inference_utils.py).

- 3DMM coefficient windows (inference_utils.py:73-99): ``split_coeff``,
  ``transform_semantic`` (DNet's driving input for every frame at once,
  over edge-clamped windows: ``gather_windows``) and
  ``find_crop_norm_ratio``.
- OpenCV-convention mask helpers of GPEN's enhancer (inference_utils.py:
  59-64), NCHW: ``gaussian_blur`` is cv2.GaussianBlur(ksize, sigma) with a
  REFLECT_101 border, run as two banded-matrix matmuls (the border folded
  into the matrices); ``mask_postprocess`` zeroes a border and blurs twice
  with (101, sigma 11).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch


def split_coeff(coeffs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, 257] ReconNet output -> named groups (inference_utils.py:158-179)."""
    return {"id": coeffs[:, :80], "exp": coeffs[:, 80:144], "tex": coeffs[:, 144:224],
            "angle": coeffs[:, 224:227], "gamma": coeffs[:, 227:254], "trans": coeffs[:, 254:]}


def window_offsets(window: int) -> np.ndarray:
    """Frame offsets of a temporal window: obtain_seq_index
    (inference_utils.py:73-76) is ``range(i - 13, i + 13)``, offsets
    ``arange(window) - window // 2``."""
    return np.arange(window) - window // 2


def gather_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[N, ...] -> [N, window, ...], indices clamped to [0, N - 1] as
    obtain_seq_index clips them."""
    n = x.shape[0]
    idx = np.clip(np.arange(n)[:, None] + window_offsets(window)[None], 0, n - 1)
    return x[torch.as_tensor(idx, device=x.device)]


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
