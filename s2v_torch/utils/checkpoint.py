"""Step-indexed training checkpoints (s2v_tpu/utils/checkpoint.py
``TrainCheckpointer``; the DeepSpeed save_checkpoint/load_checkpoint
analogue of the reference, emb/utils/engines.py:95-111), with
``torch.save`` in place of orbax.

A checkpoint holds what a fine-tune changes: the trainable parameters of
the state's module (those with ``requires_grad``), the optimizer's state
and the step. The frozen rest comes from the model's own files.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    """``save(step, state)`` / ``restore(state, step=None)`` (None: the
    latest) for a state with ``module``, ``opt`` and ``step`` (a
    ``s2v_torch.train.finetune.TrainState``); keeps the newest
    ``max_to_keep``. Saves are synchronous, so ``wait`` returns at once."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state) -> None:
        params = {k: p.detach().cpu() for k, p in state.module.named_parameters()
                  if p.requires_grad}
        tmp = self._path(step) + ".tmp"
        torch.save({"step": int(step), "params": params, "opt": state.opt.state_dict()}, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees half a file
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state, step: Optional[int] = None):
        """Loads the checkpoint into ``state`` in place (every saved
        parameter must exist in the module with its shape) and returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = torch.load(self._path(step), map_location="cpu", weights_only=True)
        own = dict(state.module.named_parameters())
        missing = [k for k in ckpt["params"] if k not in own]
        if missing:
            raise KeyError(f"the checkpoint's parameters {missing} are not in the module")
        with torch.no_grad():
            for k, v in ckpt["params"].items():
                own[k].copy_(v)
        state.opt.load_state_dict(ckpt["opt"])
        state.step = ckpt["step"]
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        pass
