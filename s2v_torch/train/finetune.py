"""The fine-tuning step (reference: training.py:189-471; s2v_tpu/train/
finetune.py), on one card.

The reference fine-tunes on one video with Adam, freezing everything but
ENet's style convs (ENet.set_training_style, ENet.py:141-153). Here the
frozen parameters have ``requires_grad`` off: they take no gradient and no
update, as under the JAX package's ``optax.set_to_zero``. With a ``mesh``
(a ``DeviceMesh`` of ``s2v_torch.parallel.mesh.make_process_mesh``) the step
is data-parallel: each rank feeds its shard of the batch, the gradients are
averaged over the data group before the optimizer steps, and the metrics
are the group's means, which is the global-batch step of the JAX step's
mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from s2v_torch.parallel.mesh import allreduce_grads, allreduce_mean, data_group
from s2v_torch.train.losses import l1_loss, perceptual_stub
from s2v_torch.utils import trace


@dataclass
class TrainState:
    module: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0

    def checkpoint_tree(self) -> dict:
        """What a checkpoint holds (``utils.checkpoint.state_tree``): what a
        fine-tune changes, the trainable parameters (``requires_grad``), the
        optimizer's state and the step; the frozen rest comes from the
        model's own files."""
        return {"step": int(self.step), "opt": self.opt.state_dict(),
                "params": {k: p.detach() for k, p in self.module.named_parameters()
                           if p.requires_grad}}

    def load_checkpoint_tree(self, saved: dict) -> "TrainState":
        """Loads ``checkpoint_tree``'s tree in place (every saved parameter
        must exist in the module with its shape) and returns the state."""
        own = dict(self.module.named_parameters())
        missing = [k for k in saved["params"] if k not in own]
        if missing:
            raise KeyError(f"the checkpoint's parameters {missing} are not in the module")
        with torch.no_grad():
            for k, v in saved["params"].items():
                own[k].copy_(v)
        self.opt.load_state_dict(saved["opt"])
        self.step = saved["step"]
        return self


def style_conv_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable: True exactly for names that contain
    ``style_conv`` (ENet's ``style_convs.*``), as s2v_tpu's mask matches
    them; its docstring also names the to-RGB layers, but its code, and so
    this, leaves ``to_rgbs.*`` frozen."""
    return {name: "style_conv" in name for name, _ in module.named_parameters()}


def make_optimizer(lr: float, module: nn.Module,
                   mask_fn: Optional[Callable[[nn.Module], Dict[str, bool]]] = None
                   ) -> torch.optim.Adam:
    """Adam (torch's defaults, which are optax's: betas (0.9, 0.999), eps
    1e-8 outside the square root) over the parameters ``mask_fn`` marks
    trainable, all of them without one. The others get ``requires_grad``
    off."""
    mask = mask_fn(module) if mask_fn is not None else None
    params = []
    for name, p in module.named_parameters():
        trainable = mask is None or mask[name]
        p.requires_grad_(trainable)
        if trainable:
            params.append(p)
    return torch.optim.Adam(params, lr=lr)


def init_state(module: nn.Module, opt: torch.optim.Optimizer) -> TrainState:
    return TrainState(module=module, opt=opt, step=0)


def apply_loss(state: TrainState, loss: torch.Tensor, group=None) -> None:
    """One optimizer step on ``loss``'s gradient, averaged over ``group``
    when given; ``step`` advances. The backward and the gradients' average
    run inside span ``ft.backward``, the optimizer's step inside
    ``ft.adam``."""
    state.opt.zero_grad(set_to_none=True)
    with trace.span("ft.backward"):
        loss.backward()
        allreduce_grads(state.module.parameters(), group)
    with trace.span("ft.adam"):
        state.opt.step()
    state.step += 1


def make_train_step(apply_fn: Callable, l1_weight: float = 1.0,
                    perceptual_weight: float = 0.01, mesh=None) -> Callable:
    """(state, batch) -> (state, metrics) with L1 plus the pyramid
    perceptual stand-in. ``apply_fn(module, batch)`` returns the predicted
    frames; ``batch`` has at least ``target``, on the module's device (this
    rank's shard under a ``mesh``)."""
    group = data_group(mesh)

    def step(state: TrainState, batch) -> tuple:
        pred = apply_fn(state.module, batch)
        loss_l1 = l1_loss(pred, batch["target"])
        loss_p = perceptual_stub(pred, batch["target"])
        loss = l1_weight * loss_l1 + perceptual_weight * loss_p
        apply_loss(state, loss, group)
        return state, allreduce_mean({"loss": loss.detach(), "l1": loss_l1.detach(),
                                      "perceptual": loss_p.detach()}, group)

    return step
