"""Deep3DFaceRecon training losses (reference:
third_part/face3d/models/losses.py:39-113, wired by facerecon_model.py:
feat/color/landmark/reg/gamma/reflectance; s2v_tpu/train/face3d_losses.py).
NHWC images and [B, N, 3] vertex arrays in, 0-dim tensors out, as in the
JAX package."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def perceptual_loss(feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
    """losses.py:39-42: mean (1 - cosine) over the batch (features assumed
    normalized, as the arcface embedder outputs)."""
    cos = torch.sum(feat_a * feat_b, dim=-1)
    return torch.sum(1.0 - cos) / cos.shape[0]


def photo_loss(image_a: torch.Tensor, image_b: torch.Tensor, mask: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """losses.py:45-55. NHWC images in [0,1]; mask [B,H,W,1]."""
    diff = torch.sqrt(eps + torch.sum((image_a - image_b) ** 2, dim=-1, keepdim=True)) * mask
    return torch.sum(diff) / torch.clamp(torch.sum(mask), min=1.0)


def landmark_loss(pred_lm: torch.Tensor, gt_lm: torch.Tensor,
                  weight: Optional[np.ndarray] = None) -> torch.Tensor:
    """losses.py:57-73: weighted MSE; nose bridge (28:31) and mouth (-8:)
    weighted 20x."""
    if weight is None:
        weight = np.ones([68])
        weight[28:31] = 20
        weight[-8:] = 20
        weight = weight[None]
    w = torch.as_tensor(np.asarray(weight), dtype=pred_lm.dtype, device=pred_lm.device)
    loss = torch.sum((pred_lm - gt_lm) ** 2, dim=-1) * w
    return torch.sum(loss) / (pred_lm.shape[0] * pred_lm.shape[1])


def reg_loss(coeffs: Dict[str, torch.Tensor], w_id: float = 1.0, w_exp: float = 1.0,
             w_tex: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """losses.py:77-99: coefficient L2 + near-monochromatic gamma."""
    creg = (w_id * torch.sum(coeffs["id"] ** 2)
            + w_exp * torch.sum(coeffs["exp"] ** 2)
            + w_tex * torch.sum(coeffs["tex"] ** 2)) / coeffs["id"].shape[0]
    gamma = coeffs["gamma"].reshape(-1, 3, 9)
    gamma_mean = torch.mean(gamma, dim=1, keepdim=True)
    return creg, torch.mean((gamma - gamma_mean) ** 2)


def reflectance_loss(texture: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """losses.py:101-113: albedo variance over the skin mask.
    texture [B,N,3]; mask [N]."""
    m = mask.reshape(1, -1, 1)
    mean = torch.sum(m * texture, dim=1, keepdim=True) / torch.sum(m)
    return torch.sum(((texture - mean) * m) ** 2) / (texture.shape[0] * torch.sum(m))
