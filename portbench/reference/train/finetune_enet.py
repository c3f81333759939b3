"""ENet fine-tuning on one clip, the plain reference (the fork's
training.py:189-471, github.com/Ryukhaan/speech-to-video-mpp): Adam over
ENet's style convs alone, on batches of (mel, masked face | reference,
reference, target) at 384^2, with the loss

    l1_weight * L1(pred, target)
    + perceptual_weight * VGG16 perceptual(pred, target)
    + id_weight * mean((ReconNet(pred_224) - ReconNet(target_224))^2)

Written for the ``enet_finetune`` configuration, not copied from the port:
plain torch in the precision the caller sets (the benchmark: f32 with TF32
off), over the reference's ENet (``models/enet.py``), ReconNet
(``models/resnet.py``) and VGG16 features (``models/vgg.py``). Batches are
dicts of [B, H, W, C] tensors, the layout ``build_enet_batches`` yields.

Departures from training.py, each the port's choice kept here so that the
comparison holds the port to its own documented semantics:

- ENet, ReconNet and VGG16 run in eval mode: BatchNorms use and keep their
  running statistics (the port and the JAX package hold them frozen);
- the trainable leaves are the parameters whose name holds ``style_conv``
  (``style_convs.*``; the to-RGB layers stay frozen, as in the port);
- the identity term is ReconNet's 257 coefficients of the bilinear 224^2
  resize (the port's stand-in for training.py's "ArcFaceLoss"), the
  target's taken without gradient;
- Adam is written out (torch's and optax's rule: bias-corrected moments,
  eps 1e-8 outside the square root), one leaf at a time.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from portbench.reference.models.vgg import vgg_perceptual_loss
from portbench.reference.ops.image import resize_bilinear

BATCH_KEYS = ("mel", "face", "ref", "target")


def style_conv_names(enet: nn.Module) -> list:
    """The trainable leaves: ENet's ``style_convs.*`` parameters."""
    return [k for k, _ in enet.named_parameters() if "style_conv" in k]


class Adam:
    """Adam over ``params`` (name -> leaf): m and v bias-corrected, the
    update lr * m_hat / (sqrt(v_hat) + eps); a leaf without a gradient (one
    the loss does not reach) is left alone."""

    def __init__(self, params: Dict[str, nn.Parameter], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = p.grad
            if g is None:
                continue
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def loss_terms(enet: nn.Module, recon: nn.Module, vgg: nn.Module, batch: dict,
               l1_weight: float, perceptual_weight: float, id_weight: float) -> tuple:
    """(pred, l1, perceptual, identity, loss) of a batch of NCHW tensors."""
    mel, face, ref, target = (batch[k] for k in BATCH_KEYS)
    pred, _ = enet(mel, face, ref)
    l1 = (pred - target).abs().mean()
    perceptual = vgg_perceptual_loss(vgg, pred, target)
    with torch.no_grad():
        e_target = recon(resize_bilinear(target, (224, 224)))
    identity = (recon(resize_bilinear(pred, (224, 224))) - e_target).square().mean()
    loss = l1_weight * l1 + perceptual_weight * perceptual + id_weight * identity
    return pred, l1, perceptual, identity, loss


def make_step(enet: nn.Module, recon: nn.Module, vgg: nn.Module, lr: float,
              l1_weight: float, perceptual_weight: float, id_weight: float, device):
    """Returns (the trainable leaves by name, ``step(batch) -> dict``) for
    the modules on ``device``; a step returns its prediction
    [B, 3, 384, 384], its three terms, and each trainable leaf's gradient
    (None where the loss does not reach it), after the Adam step it took."""
    for m in (enet, recon, vgg):
        m.to(device).eval().requires_grad_(False)
    params = dict(enet.named_parameters())
    trained = {k: params[k] for k in style_conv_names(enet)}
    for p in trained.values():
        p.requires_grad_(True)
    opt = Adam(trained, lr)

    def step(batch) -> dict:
        nchw = {k: torch.as_tensor(batch[k], device=device).permute(0, 3, 1, 2).contiguous()
                for k in BATCH_KEYS}
        pred, l1, perceptual, identity, loss = loss_terms(
            enet, recon, vgg, nchw, l1_weight, perceptual_weight, id_weight)
        for p in trained.values():
            p.grad = None
        loss.backward()
        opt.step()
        return dict(pred=pred.detach(), l1=float(l1.detach()),
                    perceptual=float(perceptual.detach()), id=float(identity.detach()),
                    grad={k: p.grad for k, p in trained.items()})

    return trained, step
