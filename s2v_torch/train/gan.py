"""Adversarial restoration training — the GPEN harness (reference:
third_part/GPEN/train_simple.py:69-280; s2v_tpu/train/gan.py), on one card.

Losses, as the JAX package computes them:
- D: logistic (softplus(-real) + softplus(fake)), lazy R1 gradient penalty
  every ``d_reg_every`` steps, weighted ``(r1_weight / 2) * d_reg_every``;
- G: non-saturating softplus(-fake) + smooth-L1 (+ an optional identity
  embedding loss through ``id_embed_fn``);
- EMA generator, decay ``0.5 ** (32 / (ema_kimg * 1000))`` after every
  ``g_step``.

R1 differentiates D's input gradient again, so every kernel on D's path
(``s2v_torch.ops.kernels``) runs a double backward. Batches are
``dict(lq, hq)`` of ``[B, H, W, 3]`` images in [-1, 1] (numpy or tensors),
the layout ``s2v_torch.prep.degradations.face_batches`` yields and the JAX
trainer takes; the steps move them to the device as NCHW.

Data parallel (``mesh``, a ``DeviceMesh`` of ``make_process_mesh``): each
rank feeds its shard of the batch and the steps compute the global-batch
step of the JAX trainer's sharded program. D's minibatch-stddev channel
takes the whole batch (``s2v_torch.models.gpen.minibatch_stddev`` over the
data group); R1 differentiates D's output through that collective and then
differentiates again; after each backward the flattened gradients are
averaged over the group by hand (``allreduce_grads``) instead of wrapping G
and D in ``DistributedDataParallel``. The metrics are the group's means.
The EMA and the Adam state stay replicated: the same averaged gradients
step the same states on every rank (``replicas_agree`` checks it).

Spans (``s2v_torch.utils.trace``): ``gan.d_step`` with ``gan.r1`` inside it
on the steps R1 falls on, ``gan.g_step`` with ``gan.ema`` inside it.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.device import resolve_device
from s2v_torch.models.gpen import Blur, EqualLinear, FusedLeakyReLU, Upsample
from s2v_torch.parallel.mesh import allreduce_grads, allreduce_mean, data_group
from s2v_torch.utils import trace


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_pred).mean()


def smooth_l1(a: torch.Tensor, b: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (a - b).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def r1_penalty(disc: Callable, real: torch.Tensor) -> torch.Tensor:
    """d_r1_loss (train_simple.py:76-82): the batch mean of ||dD(x)/dx||^2,
    kept differentiable in D's parameters (``disc``: D, or D over a group)."""
    real = real.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(disc(real).sum(), real, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(1).mean()


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """accumulate() (train_simple.py:54-60), in place on ``ema``'s
    parameters: ``e * decay + p * (1 - decay)``."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * decay + p * (1.0 - decay))


@contextmanager
def _frozen(module: nn.Module):
    """No gradient accumulates into ``module``'s parameters inside."""
    flags = [p.requires_grad for p in module.parameters()]
    for p in module.parameters():
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


@dataclass
class GANState:
    g: nn.Module
    d: nn.Module
    g_ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def make_gan_trainer(
    g: nn.Module,            # lq images [B, 3, H, W] -> fake images
    d: nn.Module,            # images [B, 3, H, W] -> [B, 1] logits
    device=None,
    g_lr: float = 2e-3,
    d_lr: float = 2e-3,
    r1_weight: float = 10.0,
    d_reg_every: int = 16,
    l1_weight: float = 1.0,
    id_weight: float = 1.0,
    id_embed_fn: Optional[Callable] = None,  # images [B, 3, H, W] -> [B, E]
    ema_kimg: float = 10.0,
    mesh=None,
):
    """Returns ``(state, d_step, g_step)``; each step takes ``(state,
    batch)`` and returns ``(state, metrics)`` with the JAX trainer's metric
    keys (0-dim tensors on the device). ``device`` defaults to the card and
    raises without one; pass ``"cpu"`` to train on the CPU on purpose.
    ``step`` advances in ``g_step`` only; R1 runs in the ``d_step`` taken
    when ``step % d_reg_every == 0``. With a ``mesh`` the batches are this
    rank's shards of the global batch."""
    dev = resolve_device(device)
    group = data_group(mesh)
    g, d = g.to(dev).train(), d.to(dev).train()
    g_ema = copy.deepcopy(g).eval().requires_grad_(False)
    state = GANState(
        g=g, d=d, g_ema=g_ema,
        g_opt=torch.optim.Adam(g.parameters(), lr=g_lr, betas=(0.0, 0.99), eps=1e-8),
        d_opt=torch.optim.Adam(d.parameters(), lr=d_lr, betas=(0.0, 0.99), eps=1e-8))
    ema_decay = 0.5 ** (32.0 / (ema_kimg * 1000.0))

    def images(batch, key):
        return torch.as_tensor(batch[key], device=dev).permute(0, 3, 1, 2).contiguous()

    def disc(x):
        return state.d(x, group=group)

    @trace.span("gan.d_step")
    def d_step(state: GANState, batch) -> tuple:
        lq, hq = images(batch, "lq"), images(batch, "hq")
        with torch.no_grad():
            fake = state.g(lq)
        loss = d_logistic_loss(disc(hq), disc(fake))
        if state.step % d_reg_every == 0:
            with trace.span("gan.r1"):
                r1 = r1_penalty(disc, hq)
            # lazy regularization (train_simple.py:197-203)
            loss = loss + (r1_weight / 2.0) * r1 * d_reg_every
        else:
            r1 = torch.zeros((), device=dev)
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        allreduce_grads(state.d.parameters(), group)
        state.d_opt.step()
        return state, allreduce_mean({"d_loss": loss.detach(), "r1": r1.detach()}, group)

    @trace.span("gan.g_step")
    def g_step(state: GANState, batch) -> tuple:
        lq, hq = images(batch, "lq"), images(batch, "hq")
        with _frozen(state.d):
            fake = state.g(lq)
            loss = g_nonsaturating_loss(disc(fake))
            loss_l1 = smooth_l1(fake, hq)
            loss = loss + l1_weight * loss_l1
            # g_adv holds the adversarial loss plus the weighted L1, as the
            # JAX trainer reports it
            metrics: Dict[str, torch.Tensor] = {"g_adv": loss.detach(),
                                                "l1": loss_l1.detach()}
            if id_embed_fn is not None:
                ef = id_embed_fn(fake)
                with torch.no_grad():
                    er = id_embed_fn(hq)
                loss_id = (1.0 - (ef * er).sum(-1)).mean()
                loss = loss + id_weight * loss_id
                metrics["id"] = loss_id.detach()
            metrics["g_loss"] = loss.detach()
            state.g_opt.zero_grad(set_to_none=True)
            loss.backward()
        allreduce_grads(state.g.parameters(), group)
        state.g_opt.step()
        with trace.span("gan.ema"):
            ema_update(state.g_ema, state.g, ema_decay)
        state.step += 1
        return state, allreduce_mean(metrics, group)

    return state, d_step, g_step


def kernel_sites(module: nn.Module) -> tuple:
    """(K1, K3) call sites of one forward of a module built from the GPEN
    layers (a GPEN generator or discriminator, GFPGAN's
    ``FacialComponentDiscriminator``): every FusedLeakyReLU and fused
    EqualLinear, every Blur and Upsample. A module without them (VGG16,
    IR-SE50, GFPGANv1Clean) has none."""
    mods = list(module.modules())
    k1 = sum(isinstance(m, FusedLeakyReLU)
             or (isinstance(m, EqualLinear) and m.activation == "fused_lrelu") for m in mods)
    return k1, sum(isinstance(m, (Blur, Upsample)) for m in mods)


def expected_train_launches(g: nn.Module, d: nn.Module) -> dict:
    """Kernel launches per step kind of a GPEN ``FullGenerator`` ``g`` and
    ``Discriminator`` ``d`` under ``make_gan_trainer``, derived from their
    kernel sites (G: g1, g3; D: d1, d3; D's trunk before the minibatch-stddev
    channel: c1, c3):
    - d_step: G forward without grad; D forward and backward on real and on
      fake: every K1 gets a K2 and every K3 a K3 backward;
    - R1 d_step adds a third D forward with the input's gradient taken with
      create_graph (K2 and K3 once more per site), whose double backward
      runs K2 (with b) and K3 per site again, and reaches the trunk's
      forward again through the stddev channel (c1 K2, c3 K3);
    - g_step: G and D forward and backward; D's parameters take no gradient
      but D's input does, so every site still runs its backward."""
    (g1, g3), (d1, d3), (c1, c3) = kernel_sites(g), kernel_sites(d), kernel_sites(d.convs)
    return {
        "d": {"fused_act": g1 + 2 * d1, "fused_act_bwd": 2 * d1, "upfirdn2d": g3 + 4 * d3},
        "d_r1": {"fused_act": g1 + 3 * d1, "fused_act_bwd": 4 * d1 + c1,
                 "upfirdn2d": g3 + 7 * d3 + c3},
        "g": {"fused_act": g1 + d1, "fused_act_bwd": g1 + d1, "upfirdn2d": 2 * (g3 + d3)},
    }


def expected_gfpgan_launches(g: nn.Module, d: nn.Module, comps: dict) -> dict:
    """Kernel launches per step kind of ``s2v_torch.train.gfpgan_train.
    make_gfpgan_trainer`` with generator ``g``, global discriminator ``d``
    and component discriminators ``comps`` (name -> module), derived from
    their kernel sites (G: g1, g3; D: d1, d3; the components' summed: c1,
    c3). Every K1 site that takes a gradient runs one K2, every K3 site one
    more K3:
    - g_step: G forward and backward; D forward on ``fake`` and backward
      (D's parameters take no gradient, its input does); each component on
      the fake crop forward and backward, and on the real crop forward
      only: those features run without a graph (the JAX step's
      stop_gradient), so they add no backward launch;
    - d_step: G forward without grad; D forward and backward on real and
      on fake; each component the same on its real and fake crops."""
    (g1, g3), (d1, d3) = kernel_sites(g), kernel_sites(d)
    c1 = sum(kernel_sites(c)[0] for c in comps.values())
    c3 = sum(kernel_sites(c)[1] for c in comps.values())
    return {
        "g": {"fused_act": g1 + d1 + 2 * c1, "fused_act_bwd": g1 + d1 + c1,
              "upfirdn2d": 2 * (g3 + d3) + 3 * c3},
        "d": {"fused_act": g1 + 2 * (d1 + c1), "fused_act_bwd": 2 * (d1 + c1),
              "upfirdn2d": g3 + 4 * (d3 + c3)},
    }
