"""GPEN-BFR-512 adversarial training (sizes in ``gpen512_train.json``): the
weights from the seed, the program's trainer (``s2v_torch.train.gan``) and
the plain reference's (``portbench.reference.train.gan``, with K1-K3 in
plain PyTorch), each over the same weights, in float32 without TF32.

The weights are the classes' own initialisation (GPEN's: unit normal
weights under equalised learning rates, zero biases), drawn on the card
from ``--seed`` with the reference's classes, and loaded into both sides.
"""

from __future__ import annotations

from typing import Dict

DRIVER = "gan_pool"


def reference_models(torch, sizes: dict, device):
    from portbench.reference.models.gpen import Discriminator, FullGenerator

    with torch.device(device):
        return FullGenerator(**sizes["generator"]), Discriminator(**sizes["discriminator"])


def make_weights(torch, sizes: dict, seed: int, device) -> Dict[str, dict]:
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(int(seed) % (2 ** 63))
        g, d = reference_models(torch, sizes, dev)
    return dict(g=g.state_dict(), d=d.state_dict())


def _trainer(make, g, d, weights, sizes, device):
    g.load_state_dict(weights["g"], strict=True)
    d.load_state_dict(weights["d"], strict=True)
    lr, (b1, b2) = sizes["lr"], sizes["betas"]
    if (b1, b2) != (0.0, 0.99):
        raise ValueError("the trainers' Adam betas are GPEN's (0, 0.99)")
    return make(g, d, device=device, g_lr=lr, d_lr=lr, r1_weight=sizes["r1"],
                d_reg_every=sizes["d_reg_every"], l1_weight=sizes["lambda_l1"],
                ema_kimg=sizes["ema_kimg"])


def program_trainer(torch, sizes: dict, weights: dict, device):
    """(state, d_step, g_step) of ``s2v_torch.train.gan.make_gan_trainer``."""
    from s2v_torch.models.gpen import Discriminator, FullGenerator
    from s2v_torch.train.gan import make_gan_trainer

    with torch.device(device):
        g, d = FullGenerator(**sizes["generator"]), Discriminator(**sizes["discriminator"])
    return _trainer(make_gan_trainer, g, d, weights, sizes, device)


def reference_trainer(torch, sizes: dict, weights: dict, device):
    from portbench.reference.train.gan import make_gan_trainer

    g, d = reference_models(torch, sizes, device)
    return _trainer(make_gan_trainer, g, d, weights, sizes, device)


def step_flops(torch, sizes: dict) -> Dict[str, int]:
    """FLOPs of the reference's d_step, R1 d_step and g_step at the
    configuration's shapes (forward, backward and R1's double backward; the
    optimizer's elementwise work is not counted), on the meta device."""
    from portbench.core.flops import count
    from portbench.reference.train.gan import (d_logistic_loss, g_nonsaturating_loss,
                                               r1_penalty, smooth_l1)

    g, d = reference_models(torch, sizes, "meta")
    n, s = sizes["batch"], sizes["generator"]["size"]
    lq = torch.empty(n, 3, s, s, device="meta")
    hq = torch.empty(n, 3, s, s, device="meta")

    def d_step(r1: bool):
        with torch.no_grad():
            fake = g(lq)
        loss = d_logistic_loss(d(hq), d(fake))
        if r1:
            loss = loss + r1_penalty(d, hq)
        loss.backward()

    def g_step():
        for p in d.parameters():
            p.requires_grad_(False)
        fake = g(lq)
        (g_nonsaturating_loss(d(fake)) + smooth_l1(fake, hq)).backward()
        for p in d.parameters():
            p.requires_grad_(True)

    return {"d": count(torch, lambda: d_step(False)), "d_r1": count(torch, lambda: d_step(True)),
            "g": count(torch, g_step)}
