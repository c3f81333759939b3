"""GFPGAN training (reference: GFPGAN/gfpgan/models/gfpgan_model.py:19-553
and archs/gfpganv1_arch.py:405-439; s2v_tpu/train/gfpgan_train.py), on one
card, NCHW.

- ``FacialComponentDiscriminator``: the eyes / mouth discriminator, built
  from GPEN ``ConvLayer``s, so its blurs run K3 and its activations K1
  (K2 and K3 again in backward) through ``s2v_torch.ops.kernels``;
- ``roi_crop``: fixed-size crops around each image's component centre
  (the reference's ROIAlign on boxes, as the JAX package crops it);
- ``gram_mat`` and ``component_style_loss``: L1 between Gram matrices of
  the component discriminator's features;
- ``make_gfpgan_trainer``: one generator step (pixel L1, perceptual,
  global and component GAN, component style, identity) and one step of the
  global and the component discriminators under one Adam.

The trainer is generic over its modules, as the JAX function is over its
applies: any generator, any global discriminator, any component
discriminators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.device import resolve_device
from s2v_torch.models.gpen import ConvLayer
from s2v_torch.train.gan import _frozen, d_logistic_loss, g_nonsaturating_loss

ROI_SIZES = {"left_eye": 80, "right_eye": 80, "mouth": 120}


class FacialComponentDiscriminator(nn.Module):
    """gfpganv1_arch.py:405-439, basicsr's key names (``conv1.0.weight``,
    ``conv1.1.bias``, ``conv2.0.kernel``, ..., ``final_conv.0.weight`` and
    ``.bias``). Returns (logits [B, 1, H/4, W/4], [conv3's, conv5's
    features] with ``return_feats``, else None)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvLayer(3, 64, 3)
        self.conv2 = ConvLayer(64, 128, 3, downsample=True)
        self.conv3 = ConvLayer(128, 128, 3)
        self.conv4 = ConvLayer(128, 256, 3, downsample=True)
        self.conv5 = ConvLayer(256, 256, 3)
        self.final_conv = ConvLayer(256, 1, 3, activate=False)

    def forward(self, x, return_feats: bool = False):
        f1 = self.conv3(self.conv2(self.conv1(x)))
        f2 = self.conv5(self.conv4(f1))
        return self.final_conv(f2), ([f1, f2] if return_feats else None)


def roi_crop(images: torch.Tensor, centers, size: int) -> torch.Tensor:
    """images [B, C, H, W]; centers [B, 2] (x, y) pixels, numpy or a tensor
    -> [B, C, size, size]. Each centre is truncated toward zero (as
    ``astype(int32)``), the window's corner clamped into the image."""
    b, _, h, w = images.shape
    c = torch.as_tensor(np.asarray(centers, np.float32) if not torch.is_tensor(centers)
                        else centers.float(), device=images.device).trunc().long()
    half = size // 2
    x0 = (c[:, 0] - half).clamp(0, w - size)
    y0 = (c[:, 1] - half).clamp(0, h - size)
    r = torch.arange(size, device=images.device)
    ys, xs = (y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images.permute(0, 2, 3, 1)[bi, ys, xs].permute(0, 3, 1, 2)


def gram_mat(x: torch.Tensor) -> torch.Tensor:
    """gfpgan_model.py:267-281. x [B, C, H, W] -> [B, C, C] / (C*H*W)."""
    b, c, h, w = x.shape
    f = x.reshape(b, c, h * w)
    return f @ f.transpose(1, 2) / (c * h * w)


def component_style_loss(feats_fake, feats_real) -> torch.Tensor:
    """gfpgan_model.py:362-380: L1 between the Gram matrices of the two
    feature levels, the real side's without gradient."""
    loss = 0.0
    for f, r in zip(feats_fake, feats_real):
        loss = loss + (gram_mat(f) - gram_mat(r).detach()).abs().mean()
    return loss


@dataclass
class GFPGANState:
    g: nn.Module
    d: nn.Module
    comps: nn.ModuleDict
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def make_gfpgan_trainer(
    g: nn.Module,                   # lq [B, 3, S, S] -> restored [B, 3, S, S]
    d: nn.Module,                   # images -> [B, 1] logits
    comps: Dict[str, nn.Module],    # left_eye / right_eye / mouth -> (logits, feats)
    device=None,
    vgg_loss_fn: Optional[Callable] = None,   # (fake, gt) NCHW in [-1, 1] -> loss
    id_embed_fn: Optional[Callable] = None,   # images -> [B, E]
    g_lr: float = 2e-3,
    d_lr: float = 2e-3,
    roi_sizes: Optional[Dict[str, int]] = None,
    pixel_weight: float = 0.1,
    perceptual_weight: float = 1.0,
    gan_weight: float = 0.1,
    comp_gan_weight: float = 1.0,
    comp_style_weight: float = 200.0,
    id_weight: float = 10.0,
):
    """GFPGANModel.optimize_parameters (gfpgan_model.py:283-450) as the JAX
    package's ``make_gfpgan_trainer`` computes it. Returns ``(state,
    g_step, d_step)``; each step takes ``(state, batch)`` with ``batch =
    dict(lq, gt [B, S, S, 3] in [-1, 1], loc_{name} [B, 2] ROI centres)``
    (numpy or tensors) and returns ``(state, metrics)`` with the JAX
    trainer's metric keys (0-dim tensors on the device). ``device``
    defaults to the card and raises without one; pass ``"cpu"`` to train
    on the CPU on purpose.

    - g_step: the discriminators take no gradient and no update, but
      gradients flow through them to ``fake``; the real crops' features run
      without a graph (the JAX step's stop_gradient); ``step`` advances.
    - d_step: ``fake`` regenerated without a graph; one Adam (0.9, 0.99)
      over the global and the component discriminators together.
    No R1 and no EMA: the JAX trainer has neither."""
    dev = resolve_device(device)
    roi_sizes = roi_sizes or ROI_SIZES
    g, d = g.to(dev).train(), d.to(dev).train()
    comps = nn.ModuleDict(comps).to(dev).train()
    state = GFPGANState(
        g=g, d=d, comps=comps,
        g_opt=torch.optim.Adam(g.parameters(), lr=g_lr, betas=(0.9, 0.99), eps=1e-8),
        d_opt=torch.optim.Adam(list(d.parameters()) + list(comps.parameters()), lr=d_lr,
                               betas=(0.9, 0.99), eps=1e-8))

    def images(batch, key):
        return torch.as_tensor(batch[key], device=dev).permute(0, 3, 1, 2).contiguous()

    def rois(fake, real, batch, name):
        size = roi_sizes[name]
        loc = batch[f"loc_{name}"]
        return roi_crop(fake, loc, size), roi_crop(real, loc, size)

    def g_step(state: GFPGANState, batch) -> tuple:
        lq, gt = images(batch, "lq"), images(batch, "gt")
        with _frozen(state.d), _frozen(state.comps):
            fake = state.g(lq)
            loss = pixel_weight * (fake - gt).abs().mean()
            metrics: Dict[str, torch.Tensor] = {"pixel": loss.detach()}
            if vgg_loss_fn is not None:
                p = vgg_loss_fn(fake, gt)
                loss = loss + perceptual_weight * p
                metrics["percep"] = p.detach()
            adv = g_nonsaturating_loss(state.d(fake))
            loss = loss + gan_weight * adv
            metrics["adv"] = adv.detach()
            for name, comp in state.comps.items():
                fcrop, rcrop = rois(fake, gt, batch, name)
                pred, feats_f = comp(fcrop, return_feats=True)
                with torch.no_grad():
                    _, feats_r = comp(rcrop, return_feats=True)
                comp_adv = g_nonsaturating_loss(pred)
                loss = (loss + comp_gan_weight * comp_adv
                        + comp_style_weight * component_style_loss(feats_f, feats_r))
                metrics[f"{name}_adv"] = comp_adv.detach()
            if id_embed_fn is not None:
                with torch.no_grad():
                    er = id_embed_fn(gt)
                lid = (id_embed_fn(fake) - er).abs().mean()
                loss = loss + id_weight * lid
                metrics["id"] = lid.detach()
            metrics["g_total"] = loss.detach()
            state.g_opt.zero_grad(set_to_none=True)
            loss.backward()
        state.g_opt.step()
        state.step += 1
        return state, metrics

    def d_step(state: GFPGANState, batch) -> tuple:
        lq, gt = images(batch, "lq"), images(batch, "gt")
        with torch.no_grad():
            fake = state.g(lq)
        loss = d_logistic_loss(state.d(gt), state.d(fake))
        metrics = {"d_global": loss.detach()}
        for name, comp in state.comps.items():
            fcrop, rcrop = rois(fake, gt, batch, name)
            part = d_logistic_loss(comp(rcrop)[0], comp(fcrop)[0])
            loss = loss + part
            metrics[f"d_{name}"] = part.detach()
        metrics["d_total"] = loss.detach()
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        state.d_opt.step()
        return state, metrics

    return state, g_step, d_step
