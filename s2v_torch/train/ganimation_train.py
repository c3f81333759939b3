"""GANimation and StarGAN expression training (reference:
third_part/ganimation_replicate/model/ganimation.py:50-117, stargan.py:57-108
and base_model.py:148-164, wgan-gp configuration;
s2v_tpu/train/ganimation_train.py), on one card, NCHW.

Forward (ganimation.py:50-58): generate fake = att * src + (1 - att) * color
from target AUs, then reconstruct real from the fake with the source AUs.
D: wgan loss on real/fake + AU regression MSE on real + gradient penalty at
random interpolates. G: wgan fake score + AU regression on fake + L1 cycle
reconstruction + attention-mask sparsity + total-variation smoothness.
StarGAN shares the generator and critic; its fake is the colour output
itself, without the attention composite or the mask and TV terms.

The generator is ``s2v_torch.models.ganimation.SplitGenerator`` (img
[B, 3, H, W] in [-1, 1], aus [B, 17] -> (color, attention, features)); the
critic is any module returning ``(score, aus)``, as in the JAX package,
which has no GANimation discriminator either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn

from s2v_torch.device import resolve_device
from s2v_torch.train.gan import _frozen


def tv_loss(mask: torch.Tensor) -> torch.Tensor:
    """Total variation on [B, 1, H, W] attention masks (criterionTV)."""
    dh = torch.mean(torch.square(mask[:, :, 1:] - mask[:, :, :-1]))
    dw = torch.mean(torch.square(mask[..., 1:] - mask[..., :-1]))
    return dh + dw


def interpolation_weight(rng: torch.Generator, n: int, device) -> torch.Tensor:
    """The penalty's per-sample interpolation weight [n, 1, 1, 1] in [0, 1),
    drawn from ``rng`` (never the global RNG) on its device."""
    return torch.rand((n, 1, 1, 1), generator=rng, device=rng.device).to(device)


def wgan_gradient_penalty(critic: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """base_model.py:148-164: (||dD/dx at interpolates|| - 1)^2, with the
    graph kept so that the penalty differentiates into the critic."""
    inter = (alpha * real + (1 - alpha) * fake).detach().requires_grad_(True)
    pred, _ = critic(inter)
    (grads,) = torch.autograd.grad(pred.sum(), inter, create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2, dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def _d_terms(critic, src_img, src_aus, fake, alpha, lambda_dis, lambda_aus, lambda_gp):
    pred_real, real_aus = critic(src_img)
    pred_fake, _ = critic(fake)
    # wgan criterionGAN: real -> -mean(pred), fake -> +mean(pred)
    loss_real = -torch.mean(pred_real)
    loss_fake = torch.mean(pred_fake)
    loss_aus = torch.mean(torch.square(real_aus - src_aus))
    gp = wgan_gradient_penalty(critic, src_img, fake, alpha)
    loss = lambda_dis * (loss_fake + loss_real) + lambda_aus * loss_aus + lambda_gp * gp
    return loss, {"d_real": loss_real.detach(), "d_fake": loss_fake.detach(),
                  "d_aus": loss_aus.detach(), "gp": gp.detach(), "d_total": loss.detach()}


def ganimation_d_loss(critic: nn.Module, gen: nn.Module, src_img, src_aus, tar_aus,
                      alpha: torch.Tensor, lambda_dis: float = 1.0, lambda_aus: float = 160.0,
                      lambda_gp: float = 10.0) -> Tuple[torch.Tensor, Dict]:
    """backward_dis (ganimation.py:60-78); the generator runs without a
    graph. ``alpha`` is the penalty's interpolation weight."""
    with torch.no_grad():
        color, att, _ = gen(src_img, tar_aus)
        fake = att * src_img + (1 - att) * color
    return _d_terms(critic, src_img, src_aus, fake, alpha, lambda_dis, lambda_aus, lambda_gp)


def ganimation_g_loss(gen: nn.Module, critic: nn.Module, src_img, src_aus, tar_aus,
                      lambda_dis: float = 1.0, lambda_aus: float = 160.0,
                      lambda_rec: float = 10.0, lambda_mask: float = 0.1,
                      lambda_tv: float = 1e-5) -> Tuple[torch.Tensor, Dict]:
    """backward_gen (ganimation.py:80-101) with the cycle reconstruction."""
    color, att, _ = gen(src_img, tar_aus)
    fake = att * src_img + (1 - att) * color
    rec_color, rec_att, _ = gen(fake, src_aus)
    rec = rec_att * fake + (1 - rec_att) * rec_color

    pred_fake, fake_aus = critic(fake)
    loss_gan = -torch.mean(pred_fake)
    loss_aus = torch.mean(torch.square(fake_aus - tar_aus))
    loss_rec = torch.mean(torch.abs(rec - src_img))
    loss_mask = torch.mean(att) + torch.mean(rec_att)
    loss_tv = tv_loss(att) + tv_loss(rec_att)
    loss = (lambda_dis * loss_gan + lambda_aus * loss_aus + lambda_rec * loss_rec
            + lambda_mask * loss_mask + lambda_tv * loss_tv)
    return loss, {"g_gan": loss_gan.detach(), "g_aus": loss_aus.detach(),
                  "g_rec": loss_rec.detach(), "g_mask": loss_mask.detach(),
                  "g_tv": loss_tv.detach(), "g_total": loss.detach()}


def stargan_d_loss(critic: nn.Module, gen: nn.Module, src_img, src_aus, tar_aus,
                   alpha: torch.Tensor, lambda_dis: float = 1.0, lambda_aus: float = 160.0,
                   lambda_gp: float = 10.0) -> Tuple[torch.Tensor, Dict]:
    """stargan.py:57-76 backward_dis (wgan-gp configuration)."""
    with torch.no_grad():
        fake, _, _ = gen(src_img, tar_aus)
    return _d_terms(critic, src_img, src_aus, fake, alpha, lambda_dis, lambda_aus, lambda_gp)


def stargan_g_loss(gen: nn.Module, critic: nn.Module, src_img, src_aus, tar_aus,
                   lambda_dis: float = 1.0, lambda_aus: float = 160.0,
                   lambda_rec: float = 10.0) -> Tuple[torch.Tensor, Dict]:
    """stargan.py:78-93 backward_gen: GAN + AU regression + cycle L1."""
    fake, _, _ = gen(src_img, tar_aus)
    rec, _, _ = gen(fake, src_aus)

    pred_fake, fake_aus = critic(fake)
    loss_gan = -torch.mean(pred_fake)
    loss_aus = torch.mean(torch.square(fake_aus - tar_aus))
    loss_rec = torch.mean(torch.abs(rec - src_img))
    loss = lambda_dis * loss_gan + lambda_aus * loss_aus + lambda_rec * loss_rec
    return loss, {"g_gan": loss_gan.detach(), "g_aus": loss_aus.detach(),
                  "g_rec": loss_rec.detach(), "g_total": loss.detach()}


@dataclass
class ExpressionState:
    g: nn.Module
    d: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer


def make_expression_trainer(gen: nn.Module, critic: nn.Module, model: str = "ganimation",
                            lr: float = 1e-4, beta1: float = 0.5, device=None):
    """optimize_paras (stargan.py:95-108 / ganimation.py:103-116): returns
    ``(state, d_step, g_step)``. ``model`` picks the objective
    ('ganimation' composes via attention; 'stargan' uses the raw output).
    Adam (beta1, 0.999) for each network.

    - ``d_step(state, src_img, src_aus, tar_aus, rng)``: the penalty's
      interpolation weight drawn from the ``torch.Generator`` ``rng``; the
      generator runs without a graph.
    - ``g_step(state, src_img, src_aus, tar_aus)``: the critic takes no
      gradient and no update; gradients flow through it to the fake.

    Images NCHW in [-1, 1], AUs [B, 17], numpy or tensors; metrics are the
    JAX steps' keys as 0-dim tensors on the device. ``device`` defaults to
    the card and raises without one; pass ``"cpu"`` to train on the CPU on
    purpose."""
    dev = resolve_device(device)
    d_loss = ganimation_d_loss if model == "ganimation" else stargan_d_loss
    g_loss = ganimation_g_loss if model == "ganimation" else stargan_g_loss
    gen, critic = gen.to(dev).train(), critic.to(dev).train()
    state = ExpressionState(
        g=gen, d=critic,
        g_opt=torch.optim.Adam(gen.parameters(), lr=lr, betas=(beta1, 0.999)),
        d_opt=torch.optim.Adam(critic.parameters(), lr=lr, betas=(beta1, 0.999)))

    def inputs(*xs):
        return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs]

    def d_step(state: ExpressionState, src_img, src_aus, tar_aus, rng: torch.Generator):
        src_img, src_aus, tar_aus = inputs(src_img, src_aus, tar_aus)
        alpha = interpolation_weight(rng, src_img.shape[0], dev)
        loss, metrics = d_loss(state.d, state.g, src_img, src_aus, tar_aus, alpha)
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.d_opt.step()
        return state, metrics

    def g_step(state: ExpressionState, src_img, src_aus, tar_aus):
        src_img, src_aus, tar_aus = inputs(src_img, src_aus, tar_aus)
        with _frozen(state.d):
            loss, metrics = g_loss(state.g, state.d, src_img, src_aus, tar_aus)
            state.g_opt.zero_grad(set_to_none=True)
            loss.backward()
        state.g_opt.step()
        return state, metrics

    return state, d_step, g_step
