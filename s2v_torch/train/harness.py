"""Multi-model training harness (reference: third_part/emb/utils/engines.py
Engine/Engines + trainer.py train(); s2v_tpu/train/harness.py).

The reference wraps DeepSpeed engines in a dict, steps them together with
per-engine timing (engines.py:121-185), checkpoints all of them with a
global step (engines.py:95-111), and drives an infinite epoch loop with a
stdin command channel broadcast to all ranks: ``eval`` / ``save`` /
``quit`` / ``cmd@step`` deferred events (trainer.py:84-208).

Here: named (state, step_fn) engines stepped inside one loop, the states
being any trainer's (``GANState``, ``GFPGANState``, ``ArcFaceState``, a dict
of tensors and optimizers); commands come from stdin or a command file
(with several processes every one reads the same file); each engine's whole
state is checkpointed with the global step (``TrainCheckpointer``); a
failing step, ``torch.OutOfMemoryError`` included, checkpoints every engine
and re-raises (engines.py:167-178).

A checkpoint saved on failure holds each state as it stood when the step
failed, under the global step before it, as DeepSpeed's ``save_on_oom``
does: the engines ahead of the failing one in the dict have taken the
step, and the failing one may have taken part of it (GPEN's ``d_step``
without its ``g_step``), since the trainers change their state in place.
``load`` from such a checkpoint resumes past its label and repeats those
updates.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import select
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from s2v_torch.utils.checkpoint import TrainCheckpointer
from s2v_torch.utils import trace
from s2v_torch.utils.diagnostics import ThroughputLogger


def state_device(state) -> Optional[torch.device]:
    """The device of the first tensor (parameter or buffer) in ``state``."""
    if isinstance(state, nn.Module):
        t = next(itertools.chain(state.parameters(), state.buffers()), None)
        return None if t is None else t.device
    if torch.is_tensor(state):
        return state.device
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        state = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        for v in state.values():
            dev = state_device(v)
            if dev is not None:
                return dev
    return None


@dataclass
class Engine:
    """One named model: a state and ``step_fn(state, batch) -> (state,
    metrics)``."""

    state: Any
    step_fn: Callable
    name: str = "model"
    elapsed_s: float = 0.0  # per-engine timing (engines.py:127-151)

    def step(self, batch):
        """One step inside span ``engine.step`` (tagged with the engine's
        name), whose record gives ``elapsed_s``."""
        with trace.span("engine.step", self.name) as s:
            self.state, metrics = self.step_fn(self.state, batch)
            dev = state_device(self.state)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the step's kernels have ended
        self.elapsed_s = s.record.seconds
        return metrics


class Engines(dict):
    """Named engine dict with joint stepping and checkpointing."""

    def __init__(self, engines: Dict[str, Engine], checkpoint_dir: Optional[str] = None):
        super().__init__(engines)
        self.global_step = 0
        self._ckptrs = ({name: TrainCheckpointer(os.path.join(checkpoint_dir, name))
                         for name in self} if checkpoint_dir else {})

    def step(self, batches: Dict[str, Any]) -> Dict[str, Dict]:
        stats = {}
        try:
            for name, batch in batches.items():
                metrics = self[name].step(batch)
                stats[name] = {**{k: float(v) for k, v in metrics.items()},
                               "elapsed_s": self[name].elapsed_s}
        except Exception:
            # save-on-failure then re-raise (engines.py:167-178 save_on_oom);
            # the states as they stand, under the step before (module docstring)
            if self._ckptrs:
                self.save()
            raise
        self.global_step += 1
        return stats

    def save(self):
        for name, ck in self._ckptrs.items():
            ck.save(self.global_step, self[name].state)

    def load(self) -> int:
        for name, ck in self._ckptrs.items():
            step = ck.latest_step()
            if step is not None:
                self[name].state = ck.restore(self[name].state, step)
                self.global_step = max(self.global_step, step)
        return self.global_step


class CommandChannel:
    """trainer.py:84-97 stdin command channel, plus a command file that
    every process of a job can read. Commands: 'save', 'eval', 'quit',
    'cmd@step'."""

    def __init__(self, command_file: Optional[str] = None):
        self.command_file = command_file
        self._deferred: Dict[int, str] = {}

    def poll(self, step: int) -> Optional[str]:
        cmd = None
        if self.command_file and os.path.isfile(self.command_file):
            with open(self.command_file) as f:
                cmd = f.read().strip() or None
            os.remove(self.command_file)
        elif sys.stdin and not sys.stdin.closed:
            try:
                ready, _, _ = select.select([sys.stdin], [], [], 0)
                if ready:
                    cmd = sys.stdin.readline().strip() or None
            except (OSError, ValueError):
                pass
        if cmd and "@" in cmd:  # deferred: cmd@step (trainer.py:159-177)
            base, at = cmd.rsplit("@", 1)
            try:
                self._deferred[int(at)] = base
                cmd = None
            except ValueError:
                pass
        if step in self._deferred:
            cmd = self._deferred.pop(step)
        return cmd


def train(engines: Engines, batch_iter: Iterable[Dict[str, Any]],
          eval_fn: Optional[Callable[[Engines], Dict]] = None, save_every: int = 1000,
          eval_every: int = 0, max_steps: Optional[int] = None,
          command_file: Optional[str] = None, log_path: Optional[str] = None) -> Engines:
    """trainer.py:100-208: 'infinite' epochs with event hooks."""
    lead = next(iter(engines.values()), None)
    logger = ThroughputLogger(log_path, every=50,
                              device=None if lead is None else state_device(lead.state))
    channel = CommandChannel(command_file)
    for batches in batch_iter:
        stats = engines.step(batches)
        first = next(iter(stats.values()))
        logger.step(engines.global_step, 1, first)

        cmd = channel.poll(engines.global_step)
        if cmd == "save" or (save_every and engines.global_step % save_every == 0):
            engines.save()
        if cmd == "eval" or (eval_every and engines.global_step % eval_every == 0):
            if eval_fn is not None:
                eval_fn(engines)
        if cmd == "quit":
            engines.save()
            break
        if max_steps and engines.global_step >= max_steps:
            break
    return engines
