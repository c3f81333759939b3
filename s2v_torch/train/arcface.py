"""Distributed face-recognition training, the arcface_torch harness
(reference: third_part/face3d/models/arcface_torch/train.py:21-133;
s2v_tpu/train/arcface.py), one process per card over a ``data x model``
``DeviceMesh`` (``s2v_torch.parallel.mesh.make_process_mesh``), or on one
device without a mesh:

- the IResNet backbone on this rank's data shard of the batch, its
  BatchNorms on the statistics of the whole batch (over the data group);
- L2-normalised features, all-gathered over the data group with autograd
  (``all_gather_cat``);
- PartialFC on the model axis (``s2v_torch.parallel.partial_fc``): this
  rank's class shard of the classifier, optionally with negative sampling;
- weight decay added to the gradient before SGD with momentum, as the optax
  chain orders it (``add_decayed_weights`` then ``sgd``), on every backbone
  parameter; the classifier on its own SGD with momentum and no decay;
- ``zero_opt``: the backbone's momentum sharded over the data group
  (ZeRO-1, ``s2v_torch.parallel.zero``).

Every rank holds the same loss. It differentiates ``loss / world size``
(each rank's copy counts once in the collectives' backward), then the
backbone's gradients are summed over the whole mesh and the classifier
shard's over the data group, which gives every rank the gradient of the
one loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from s2v_torch.device import full_f32, resolve_device
from s2v_torch.models.iresnet import IResNet
from s2v_torch.parallel.mesh import (all_gather_cat, allreduce_grads, data_group, group_size,
                                     model_group)
from s2v_torch.parallel.partial_fc import partial_fc_loss, sampling_generator, shard_rows
from s2v_torch.parallel.zero import shard_opt_state


@dataclass
class ArcFaceState:
    backbone: nn.Module
    clf_weight: torch.Tensor  # [C / model axis, E]: this rank's class shard
    opt: torch.optim.Optimizer
    clf_opt: torch.optim.Optimizer
    step: int = 0


def make_arcface_trainer(num_classes: int, mesh=None, embedding_size: int = 512,
                         layers: Tuple[int, ...] = (3, 4, 14, 3), lr: float = 0.02,
                         momentum: float = 0.9, weight_decay: float = 5e-4,
                         margin_kind: str = "arcface", seed: int = 0, sample_rate: float = 1.0,
                         zero_opt: bool = True, device=None, backbone: Optional[nn.Module] = None,
                         clf_weight=None):
    """Returns ``(state, train_step)``; ``train_step(state, images, labels)
    -> (state, {"loss"})`` takes this rank's data shard: images [b, 112,
    112, 3] (the JAX layout, numpy or a tensor) and their labels [b], global
    class ids. The backbone (an ``IResNet(layers, embedding_size)`` made from
    ``seed`` unless given) and the whole classifier ``clf_weight`` [C, E]
    (N(0, 0.01^2) from ``seed`` unless given) start the same on every rank.
    Negatives are drawn from ``sampling_generator(seed, step, shard)``.
    ``device`` defaults to the card and raises without one."""
    dev = resolve_device(device)
    dgroup, mgroup = data_group(mesh), model_group(mesh)
    world = group_size(dgroup) * group_size(mgroup)
    gen = torch.Generator().manual_seed(seed)
    if backbone is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            backbone = IResNet(layers, embedding_size)
    if clf_weight is None:
        clf_weight = torch.randn(num_classes, embedding_size, generator=gen) * 0.01
    backbone = backbone.to(dev).train()
    clf = shard_rows(torch.as_tensor(clf_weight, dtype=torch.float32), mgroup)
    clf = clf.to(dev).clone().requires_grad_(True)
    sgd = dict(lr=lr, momentum=momentum, weight_decay=weight_decay)
    opt = (shard_opt_state(backbone.parameters(), dgroup, torch.optim.SGD, **sgd) if zero_opt
           else torch.optim.SGD(backbone.parameters(), **sgd))
    state = ArcFaceState(backbone=backbone, clf_weight=clf, opt=opt,
                         clf_opt=torch.optim.SGD([clf], lr=lr, momentum=momentum))
    shard = 0 if mgroup is None else torch.distributed.get_rank(mgroup)

    def train_step(state: ArcFaceState, images, labels) -> tuple:
        x = torch.as_tensor(images, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
        y = torch.as_tensor(labels, dtype=torch.long, device=dev)
        with full_f32():
            feats = state.backbone(x, dgroup)
            feats = feats * torch.rsqrt(feats.square().sum(1, keepdim=True) + 1e-12)
            if dgroup is not None:
                feats = all_gather_cat(feats, dgroup)
                ys = [torch.empty_like(y) for _ in range(group_size(dgroup))]
                torch.distributed.all_gather(ys, y, group=dgroup)
                y = torch.cat(ys)
            generator = (sampling_generator(seed, state.step, shard) if sample_rate < 1.0
                         else None)
            loss = partial_fc_loss(feats, y, state.clf_weight, mgroup, margin_kind,
                                   sample_rate=sample_rate, generator=generator)
            state.opt.zero_grad(set_to_none=True)
            state.clf_opt.zero_grad(set_to_none=True)
            (loss / world).backward()
        params = list(state.backbone.parameters())
        allreduce_grads(params, dgroup, op="sum")
        allreduce_grads(params, mgroup, op="sum")
        allreduce_grads([state.clf_weight], dgroup, op="sum")
        state.opt.step()
        state.clf_opt.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return state, train_step
