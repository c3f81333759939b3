"""OpenCV-convention mask helpers of GPEN's enhancer (reference:
futils/inference_utils.py:59-64), NCHW.

``gaussian_blur`` is cv2.GaussianBlur(ksize, sigma) with a REFLECT_101
border, run as two banded-matrix matmuls (the border folded into the
matrices); ``mask_postprocess`` zeroes a border and blurs twice with
(101, sigma 11).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """x [B, C, H, W] f32: vertical pass, then horizontal (cv2's order)."""
    h, w = x.shape[-2:]
    mv = torch.from_numpy(_blur_matrix(h, ksize, sigma)).to(x.device)
    mh = torch.from_numpy(_blur_matrix(w, ksize, sigma)).to(x.device)
    x = torch.einsum("ih,bchw->bciw", mv, x)
    return torch.einsum("jw,bchw->bchj", mh, x)


def mask_postprocess(mask: torch.Tensor, thres: int = 20) -> torch.Tensor:
    """mask [B, 1, H, W]: zero a ``thres`` border, then blur twice with
    GaussianBlur(101, 11)."""
    h, w = mask.shape[-2:]
    m = torch.zeros_like(mask)
    m[..., thres:h - thres, thres:w - thres] = mask[..., thres:h - thres, thres:w - thres]
    return gaussian_blur(gaussian_blur(m, 101, 11.0), 101, 11.0)
