"""Deep3DFaceRecon training step (reference: face3d/models/facerecon_model.py
:17-140 — ReconNet regresses 257 coeffs; losses combine arcface feature
cosine, masked photometric error on the nvdiffrast render, weighted
landmark MSE, and coefficient/gamma/reflectance regularization;
s2v_tpu/train/face3d_train.py), on one card.

ReconNet trains in train mode: its BatchNorms normalise by the batch and
update their running statistics with torch's momentum and unbiased
variance, the convention s2v_tpu's BatchNorm2d copies. The step runs in
full f32 without TF32. The render goes through ``s2v_torch.models.bfm
.rasterize``, whose pass over the faces carries no gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.device import full_f32, resolve_device
from s2v_torch.models.bfm import ParametricFaceModel, rasterize
from s2v_torch.models.resnet import ReconNet
from s2v_torch.pipeline.utils import split_coeff
from s2v_torch.train.face3d_losses import (landmark_loss, perceptual_loss, photo_loss,
                                           reflectance_loss, reg_loss)
from s2v_torch.train.finetune import TrainState

# facerecon_model.py default loss weights (w_feat 0.2, w_color 1.92,
# w_reg 3e-4, w_gamma 10, w_lm 1.6e-3, w_reflc 5)
DEFAULT_WEIGHTS = dict(feat=0.2, color=1.92, reg=3.0e-4, gamma=10.0, lm=1.6e-3, reflc=5.0)


def clip_by_global_norm_(params, max_norm: float = 1.0) -> None:
    """optax.clip_by_global_norm in place, without a host sync: every
    gradient divided by ``norm / max_norm`` when the global norm exceeds
    ``max_norm``, left as it is otherwise (torch's ``clip_grad_norm_``
    scales by ``max_norm / (norm + 1e-6)`` instead)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    denom = torch.clamp(norm / max_norm, min=1.0)
    for g in grads:
        g.div_(denom)


def make_face3d_train_step(
    face_model: ParametricFaceModel,
    skin_mask: Optional[np.ndarray] = None,
    id_embed_fn: Optional[Callable] = None,
    lr: float = 1e-4,
    image_size: int = 224,
    weights: Optional[Dict[str, float]] = None,
    render_faces: Optional[np.ndarray] = None,
    device=None,
):
    """Returns ``(init_fn, step_fn)``. ``init_fn(seed=0, recon=None)`` gives
    a ``TrainState`` of a ReconNet (a new ResNet50 one from ``seed`` when
    ``recon`` is None) with its Adam; ``step_fn(state, batch) -> (state,
    metrics)``, the JAX step's metric keys as 0-dim tensors on the device.
    Batches: dict(image [B, S, S, 3] in [0, 1], gt_lm [B, 68, 2], mask
    [B, S, S, 1] skin region, optional), NHWC, numpy or tensors.
    ``id_embed_fn`` maps NHWC images to normalised features; the targets'
    run without a graph. ``device`` defaults to the card and raises without
    one; pass ``"cpu"`` to train on the CPU on purpose."""
    dev = resolve_device(device)
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    face_model = face_model.to(dev)
    faces = (face_model.face_buf if render_faces is None
             else torch.as_tensor(np.asarray(render_faces), dtype=torch.int64, device=dev))
    skin = (None if skin_mask is None
            else torch.as_tensor(np.asarray(skin_mask), dtype=torch.float32, device=dev))

    def init_fn(seed: int = 0, recon: Optional[nn.Module] = None) -> TrainState:
        if recon is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                recon = ReconNet()
        recon = recon.to(dev).train()
        return TrainState(module=recon, opt=torch.optim.Adam(recon.parameters(), lr=lr))

    def step_fn(state: TrainState, batch) -> tuple:
        image = torch.as_tensor(batch["image"], dtype=torch.float32, device=dev)
        gt_lm = torch.as_tensor(batch["gt_lm"], dtype=torch.float32, device=dev)
        with full_f32():
            coeffs = state.module(image.permute(0, 3, 1, 2))
            vertex, texture, color, pred_lm = face_model.compute_for_render(coeffs)
            # the reference step's camera: rasterize's default focal and
            # centre (1015, 112), whatever the face model's own camera is
            render, mask_r = rasterize(vertex, faces, color, image_size)
            if "mask" in batch:
                mask_r = mask_r * torch.as_tensor(batch["mask"], dtype=torch.float32, device=dev)
            loss_color = photo_loss(render, image, mask_r)
            loss_lm = landmark_loss(pred_lm, gt_lm)
            creg, gamma = reg_loss(split_coeff(coeffs))
            loss = (w["color"] * loss_color + w["lm"] * loss_lm + w["reg"] * creg
                    + w["gamma"] * gamma)
            metrics = {"color": loss_color, "lm": loss_lm, "reg": creg, "gamma": gamma}
            if skin is not None:
                metrics["reflc"] = reflectance_loss(texture, skin)
                loss = loss + w["reflc"] * metrics["reflc"]
            if id_embed_fn is not None:
                feat_render = id_embed_fn(render)
                with torch.no_grad():
                    feat_image = id_embed_fn(image)
                metrics["feat"] = perceptual_loss(feat_render, feat_image)
                loss = loss + w["feat"] * metrics["feat"]
            metrics["loss"] = loss
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
        # near-degenerate triangles give the rasterizer unbounded barycentric
        # gradients; the JAX step clips (optax's form) before Adam
        clip_by_global_norm_(state.module.parameters())
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return init_fn, step_fn
