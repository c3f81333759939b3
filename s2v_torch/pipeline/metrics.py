"""Quality metrics of the JAX package's parity evaluation (s2v_tpu/
pipeline/metrics.py; BASELINE.json: LSE-C/LSE-D and PSNR parity with the
reference), NCHW.

- ``psnr`` / ``ssim``: the standard formulations (SSIM per Wang et al.
  with the 11x11 Gaussian window, sigma 1.5, over valid positions only, as
  skimage and basicsr compute it), in f32 without TF32.
- ``SyncNet`` + ``lse_metrics``: the Wav2Lip lip-sync scorer of the
  VideoReTalking paper's LSE-C/LSE-D protocol: a five-frame mouth-window
  face encoder and a mel audio encoder scored by distance; LSE-D is the
  mean true-pair distance, LSE-C the mean confidence margin over a
  +-15-frame offset sweep. ``SyncNet`` keeps wav2lip ``SyncNet_color``'s key
  names (``face_encoder.{i}`` / ``audio_encoder.{i}.conv_block.{0,1}``), so
  a syncnet checkpoint's ``state_dict`` loads strictly. Its BatchNorms run
  on their running statistics: call ``.eval()``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.device import full_f32
from s2v_torch.models.layers import ConvBNReLU


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    mse = (a.float() - b.float()).square().mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _ssim_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    n = np.arange(size) - size // 2
    g = np.exp(-(n ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """a, b: [B, C, H, W]. Mean SSIM over the valid window positions; the
    window is a depthwise ``F.conv2d``."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    a, b = a.float(), b.float()
    c = a.shape[1]
    w = torch.from_numpy(_ssim_window()).to(a.device)[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, w, groups=c)

    with full_f32():
        mu_a, mu_b = filt(a), filt(b)
        mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sa = filt(a * a) - mu_a2
        sb = filt(b * b) - mu_b2
        sab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sab + c2)) / ((mu_a2 + mu_b2 + c1) * (sa + sb + c2))
    return s.mean()


# (cin, cout, kernel, stride, padding, residual), wav2lip SyncNet_color's
FACE_SPECS = [
    (15, 32, 7, 1, 3, False),
    (32, 64, 5, (1, 2), 1, False), (64, 64, 3, 1, 1, True), (64, 64, 3, 1, 1, True),
    (64, 128, 3, 2, 1, False), (128, 128, 3, 1, 1, True), (128, 128, 3, 1, 1, True),
    (128, 256, 3, 2, 1, False), (256, 256, 3, 1, 1, True), (256, 256, 3, 1, 1, True),
    (256, 512, 3, 2, 1, False), (512, 512, 3, 1, 1, True), (512, 512, 3, 1, 1, True),
    (512, 512, 3, 2, 1, False), (512, 512, 3, 1, 0, False),
]
AUDIO_SPECS = [
    (1, 32, 3, 1, 1, False), (32, 32, 3, 1, 1, True), (32, 32, 3, 1, 1, True),
    (32, 64, 3, (3, 1), 1, False), (64, 64, 3, 1, 1, True), (64, 64, 3, 1, 1, True),
    (64, 128, 3, 3, 1, False), (128, 128, 3, 1, 1, True), (128, 128, 3, 1, 1, True),
    (128, 256, 3, (3, 2), 1, False), (256, 256, 3, 1, 1, True), (256, 256, 3, 1, 1, True),
    (256, 512, 3, 1, 0, False), (512, 512, 1, 1, 0, False),
]


class SyncNet(nn.Module):
    """Wav2Lip SyncNet: face [B, 15, 48, 96] (the lower halves of five
    frames stacked on channels), mel [B, 1, 80, 16] -> 512-d L2-normalised
    embeddings (both maps end at 1x1)."""

    def __init__(self):
        super().__init__()
        self.face_encoder = nn.Sequential(*[ConvBNReLU(*s) for s in FACE_SPECS])
        self.audio_encoder = nn.Sequential(*[ConvBNReLU(*s) for s in AUDIO_SPECS])

    def forward(self, face, mel) -> Tuple[torch.Tensor, torch.Tensor]:
        fe = self.face_encoder(face).flatten(1)
        ae = self.audio_encoder(mel).flatten(1)
        fe = fe * torch.rsqrt(fe.square().sum(-1, keepdim=True) + 1e-12)
        ae = ae * torch.rsqrt(ae.square().sum(-1, keepdim=True) + 1e-12)
        return fe, ae


def lse_metrics(face_emb: np.ndarray, audio_emb: np.ndarray,
                vshift: int = 15) -> Tuple[float, float]:
    """LSE-D / LSE-C from per-frame embeddings [N, 512] (SyncNet_python
    protocol): for each frame, distances to audio embeddings across a
    +-vshift window; LSE-D = mean true-offset distance, LSE-C = mean
    (median-of-window - min) confidence."""
    n = min(len(face_emb), len(audio_emb))
    dists = []
    for i in range(n):
        lo = max(0, i - vshift)
        hi = min(n, i + vshift + 1)
        d = np.linalg.norm(face_emb[i : i + 1] - audio_emb[lo:hi], axis=1)
        dists.append((np.linalg.norm(face_emb[i] - audio_emb[i]), d))
    lse_d = float(np.mean([t for t, _ in dists]))
    lse_c = float(np.mean([np.median(d) - d.min() for _, d in dists]))
    return lse_d, lse_c
