"""ENet fine-tuning on one video, training.py done correctly (reference:
training.py:189-471: Adam(lr 0.01), 10 epochs, only ENet's style convs
trainable via set_training_style, L1 + perceptual + identity-coefficient
losses over datagen batches; s2v_tpu/train/finetune_enet.py), on one card.

The batches come from the inference pipeline's preprocessing
(``s2v_torch.train.data.build_enet_batches``). ENet stays in eval mode
while its style convs learn: its BatchNorms use and keep their running
statistics, as the JAX step applies ENet with frozen ``batch_stats``. The
step runs in full f32 without TF32, as the GPEN trainer does, and outside
the pipeline's bf16 autocast and ``no_grad`` methods. With a ``mesh`` it is
data-parallel (``s2v_torch.train.finetune``): each rank takes its shard of
every batch and the gradients are averaged over the data group; with no
batch statistics in play, that is the global-batch step.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.device import full_f32, resolve_device
from s2v_torch.ops.image import resize_bilinear
from s2v_torch.parallel.hosts import is_leader
from s2v_torch.parallel.mesh import allreduce_mean, data_group, group_size
from s2v_torch.train.finetune import (TrainState, apply_loss, init_state, make_optimizer,
                                      style_conv_mask)
from s2v_torch.train.losses import identity_loss, l1_loss, perceptual_stub

BATCH_KEYS = ("mel", "face", "ref", "target")


def make_id_embed_fn(recon: nn.Module) -> Callable:
    """Identity embedding from the face3d coefficient regressor, the
    reference's "ArcFaceLoss" capability (training.py:47-92; differentiable
    here, as in the JAX package): [B, 3, 384, 384] in [0, 1] -> ReconNet's
    [B, 257] coefficients of the bilinear 224^2 resize. ReconNet is used
    frozen, in eval mode."""
    recon.eval().requires_grad_(False)

    def embed(pred01: torch.Tensor) -> torch.Tensor:
        return recon(resize_bilinear(pred01, (224, 224)))

    return embed


def make_enet_finetune_step(enet: nn.Module, cfg, device=None,
                            id_embed_fn: Optional[Callable] = None,
                            vgg: Optional[nn.Module] = None, mesh=None):
    """Returns ``(state, step_fn)``; ``step_fn(state, batch) -> (state,
    metrics)`` with the JAX step's metric keys (0-dim tensors on the
    device). ``cfg`` is a ``TrainConfig``. Batches: dict(mel [B, 80, 16, 1],
    face [B, S, S, 6], ref [B, S, S, 3], target [B, 384, 384, 3]) in the JAX
    layout, numpy or tensors. ENet's geometry is the module's own (the JAX
    function builds the production ENet from variables). The perceptual
    term is the VGG16 one (``s2v_torch.models.vgg``) when ``vgg`` is given,
    else the pyramid stand-in; ``id_embed_fn`` adds the identity term.
    ``device`` defaults to the card and raises without one; pass ``"cpu"``
    to train on the CPU on purpose. With a ``mesh`` the batches are this
    rank's shards."""
    from s2v_torch.models.vgg import vgg_perceptual_loss

    dev = resolve_device(device)
    group = data_group(mesh)
    enet = enet.to(dev).eval()
    state = init_state(enet, make_optimizer(cfg.lr, enet, style_conv_mask))
    if vgg is not None:
        vgg = vgg.to(dev).eval().requires_grad_(False)

    def step(state: TrainState, batch) -> tuple:
        mel, face, ref, target = (
            torch.as_tensor(batch[k], device=dev).permute(0, 3, 1, 2).contiguous()
            for k in BATCH_KEYS)
        with full_f32():
            pred, _ = state.module(mel, face, ref)
            loss_l1 = l1_loss(pred, target)
            loss_p = (vgg_perceptual_loss(vgg, pred, target) if vgg is not None
                      else perceptual_stub(pred, target))
            loss = cfg.l1_weight * loss_l1 + cfg.perceptual_weight * loss_p
            metrics: Dict[str, torch.Tensor] = {"l1": loss_l1.detach(),
                                                "perceptual": loss_p.detach()}
            if id_embed_fn is not None:
                loss_id = identity_loss(pred, target, id_embed_fn)
                loss = loss + cfg.id_weight * loss_id
                metrics["id"] = loss_id.detach()
            metrics["loss"] = loss.detach()
            apply_loss(state, loss, group)
        return state, allreduce_mean(metrics, group)

    return state, step


def finetune(enet: nn.Module, batches: Iterable[Dict[str, np.ndarray]], cfg, device=None,
             checkpoint_dir: Optional[str] = None, log_path: Optional[str] = None,
             id_embed_fn: Optional[Callable] = None, vgg: Optional[nn.Module] = None,
             mesh=None) -> TrainState:
    """The training.py epoch loop (training.py:436-471): ``cfg.epochs``
    passes over ``batches`` (moved to the device once), a JSON log line
    every 10 steps and at the last (s2v_tpu's logs no last line, so a run
    of fewer than 10 steps leaves no log there), and a checkpoint every ``cfg.checkpoint_every`` epochs
    when ``checkpoint_dir`` is given. With a ``mesh`` every rank takes its
    shard of each batch; the log line counts the global batch, and only the
    leader logs and checkpoints. A batch whose size the data axis does not
    divide raises ``ValueError`` before any step, as the JAX step's
    sharding refuses it."""
    from s2v_torch.utils.checkpoint import TrainCheckpointer
    from s2v_torch.utils.diagnostics import ThroughputLogger

    group = data_group(mesh)
    n_ranks, rank = group_size(group), 0 if group is None else torch.distributed.get_rank(group)
    batches = list(batches)
    for i, b in enumerate(batches):
        if len(b["mel"]) % n_ranks:
            raise ValueError(f"batch {i} holds {len(b['mel'])} frames, which the data axis "
                             f"of size {n_ranks} does not divide")
    state, step_fn = make_enet_finetune_step(enet, cfg, device, id_embed_fn=id_embed_fn,
                                             vgg=vgg, mesh=mesh)
    dev = next(enet.parameters()).device
    batches = [{k: torch.as_tensor(b[k], device=dev).chunk(n_ranks)[rank] for k in BATCH_KEYS}
               for b in batches]
    leader = is_leader()  # one log and one checkpoint for the whole group
    logger = ThroughputLogger(log_path if leader else None, every=10, device=dev)
    ckptr = (TrainCheckpointer(checkpoint_dir, per_rank=False)
             if checkpoint_dir is not None and leader else None)
    for epoch in range(cfg.epochs):
        for i, batch in enumerate(batches):
            state, metrics = step_fn(state, batch)
            logger.step(state.step, batch["mel"].shape[0] * n_ranks,
                        {k: float(v) for k, v in metrics.items()},
                        force=epoch == cfg.epochs - 1 and i == len(batches) - 1)
        if ckptr is not None and (epoch + 1) % cfg.checkpoint_every == 0:
            ckptr.save(state.step, state)
    if ckptr is not None:
        ckptr.wait()
    return state
