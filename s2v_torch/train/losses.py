"""Fine-tuning losses (reference: training.py:47-187; s2v_tpu/train/losses.py),
NCHW.

- ``l1_loss``: L1 on the generated 384^2 crop (ENetLoss, training.py:157-187);
- ``perceptual_stub``: a multi-scale structural term over average-pool
  Laplacian pyramids, the stand-in the JAX package uses when no VGG16 file
  is given (``s2v_torch.models.vgg.vgg_perceptual_loss`` otherwise);
- ``identity_loss``: L2 between identity embeddings of pred and target, the
  target's without gradient (training.py's "ArcFaceLoss" capability).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from s2v_torch.ops.image import avg_pool_2x2, resize_bilinear


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def laplacian_pyramid(x: torch.Tensor, levels: int = 4) -> list:
    """Average-pool pyramid of residuals: ``levels`` band-pass levels, then
    the coarsest image."""
    pyr, cur = [], x
    for _ in range(levels):
        down = avg_pool_2x2(cur)
        pyr.append(cur - resize_bilinear(down, cur.shape[-2:]))
        cur = down
    pyr.append(cur)
    return pyr


def perceptual_stub(pred: torch.Tensor, target: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Mean over the pyramid's levels of their L1 distances."""
    loss = 0.0
    for p, t in zip(laplacian_pyramid(pred, levels), laplacian_pyramid(target, levels)):
        loss = loss + (p - t).abs().mean()
    return loss / (levels + 1)


def identity_loss(pred: torch.Tensor, target: torch.Tensor,
                  embed_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Mean squared distance of ``embed_fn``'s embeddings; 0 without one."""
    if embed_fn is None:
        return torch.zeros((), device=pred.device)
    with torch.no_grad():
        et = embed_fn(target)
    return (embed_fn(pred) - et).square().mean()
