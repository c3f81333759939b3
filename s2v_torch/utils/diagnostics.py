"""Training observability (reference: third_part/emb/utils/diagnostic.py
Diagnostic, per-layer activation/parameter/gradient statistics to CSV;
arcface utils/utils_logging.py AverageMeter and utils_callbacks.py
CallBackLogging samples/sec; s2v_tpu/utils/diagnostics.py): statistics of
named tensors (``tree_stats``, ``global_norm``), a running mean, JSON-line
throughput logs, ``Diagnostic`` and forward-hook activation capture
(``capture_activations``).

``tree_stats`` and ``global_norm`` stay on the tensors' device (0-dim
tensors, no host sync); ``Diagnostic`` accumulates on the host in numpy, as
s2v_tpu's does.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

Tensors = Mapping[str, Any]


def _named(tree: Tensors, prefix: str = ""):
    """(name, tensor) pairs of a mapping whose values are tensors or tuples
    and lists of them (an element named ``name/i``, as a pytree path)."""
    for name, v in tree.items():
        if isinstance(v, (tuple, list)):
            yield from _named({f"{name}/{i}": x for i, x in enumerate(v)}, prefix)
        else:
            yield prefix + name, v


def tree_stats(tree: Tensors, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Per-tensor {mean, std, absmax} of a ``state_dict`` or any mapping of
    tensors, each a 0-dim f32 tensor on its tensor's device."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in _named(tree, prefix):
        t = t.detach().float()
        out[f"{name}.mean"] = t.mean()
        out[f"{name}.std"] = t.std(correction=0)
        out[f"{name}.absmax"] = t.abs().max()
    return out


def global_norm(tree: Tensors) -> torch.Tensor:
    """The L2 norm of every tensor of the mapping together, in f32."""
    return torch.sqrt(sum(t.detach().float().square().sum() for _, t in _named(tree)))


class AverageMeter:
    """arcface utils_logging.py AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ThroughputLogger:
    """CallBackLogging: every ``every`` steps one JSON line (step,
    samples/sec since the last line, the mean loss since then, the step's
    metrics), printed and appended to ``log_path`` when given; ``force``
    writes a line at any step (a run's last). The clock is
    ``time.perf_counter``; with a CUDA ``device`` (the one the steps run
    on) the card's queue is drained before each reading, so a line's rate
    counts finished steps."""

    def __init__(self, log_path: Optional[str] = None, every: int = 50, device=None):
        self.log_path = log_path
        self.every = every
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)
        self._t0 = self._now()
        self._samples = 0
        self._last_step = 0
        self.loss = AverageMeter()

    def step(self, step: int, batch_size: int, metrics: Dict[str, float],
             force: bool = False):
        self._samples += batch_size
        if "loss" in metrics:
            self.loss.update(metrics["loss"])
        if step == self._last_step or not (force or step % self.every == 0):
            return None
        dt = max(self._now() - self._t0, 1e-9)
        record = {
            "step": step,
            "samples_per_sec": round(self._samples / dt, 2),
            "loss_avg": round(self.loss.avg, 6),
            **{k: round(float(v), 6) for k, v in metrics.items()},
        }
        line = json.dumps(record)
        print(line, flush=True)
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(line + "\n")
        self._t0 = self._now()
        self._samples = 0
        self.loss.reset()
        self._last_step = step
        return record

    def _now(self) -> float:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()


class Diagnostic:
    """Per-axis activation/param/grad statistics -> CSV (reference:
    third_part/emb/utils/diagnostic.py:19-125; s2v_tpu's ``Diagnostic``,
    whose rows and CSV this gives for the same arrays).

    Named tensors are fed in explicitly: parameters and gradients from the
    train step (``named_parameters``, a ``state_dict``), activations from
    ``capture_activations``. Accumulates abs/pos/val/rms/min/max/count per
    axis plus PCA singular values for small trailing dims, in float64 on
    the host.
    """

    def __init__(self, tag: str = "module", max_pca_dim: int = 512):
        self.tag = tag
        self.max_pca_dim = max_pca_dim
        self._history: Dict[str, Dict[str, Any]] = {}

    def _accumulate_along_axis(self, name: str, x, axis: int):
        x = np.moveaxis(np.asarray(x, np.float64), axis, -1)
        x = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None]
        size = x.shape[-1]
        h = self._history.setdefault(
            name, {"abs": 0.0, "pos": 0.0, "val": 0.0, "rms": 0.0, "cnt": 0,
                   "min": np.full(size, np.inf),
                   "max": np.full(size, -np.inf),
                   "pca": 0.0, "size": size})
        if h["size"] != size:
            return
        if size < self.max_pca_dim and len(x) > 1:
            centered = x - x.mean(0)
            q = min(6, size, len(x))  # torch.pca_lowrank default q=6
            h["pca"] = h["pca"] + np.linalg.svd(centered, compute_uv=False)[:q]
        h["abs"] = h["abs"] + np.abs(x).sum(0)
        h["pos"] = h["pos"] + np.clip(x, 0, None).sum(0)
        h["val"] = h["val"] + x.sum(0)
        h["rms"] = h["rms"] + np.square(x).sum(0)
        h["cnt"] += len(x)
        h["min"] = np.minimum(h["min"], x.min(0))
        h["max"] = np.maximum(h["max"], x.max(0))

    def accumulate(self, name: str, x, per_axis: bool = True):
        """``x``: a tensor (any device or dtype) or an array."""
        x = x.detach().cpu().double().numpy() if torch.is_tensor(x) else np.asarray(x)
        if per_axis and x.ndim > 0:
            for axis in range(x.ndim):
                self._accumulate_along_axis(f"{name}/axis_{axis}", x, axis)
        else:
            self._accumulate_along_axis(name, x.reshape(1, -1), -1)

    def accumulate_tree(self, tree: Tensors, kind: str = "param",
                        per_axis: bool = True):
        """Every tensor of a mapping (``dict(module.named_parameters())``,
        a ``state_dict``, ``capture_activations``' activations) as
        ``{name}/{kind}``."""
        for name, t in _named(tree):
            self.accumulate(f"{name}/{kind}", t, per_axis=per_axis)

    def rows(self):
        out = []
        for name, h in sorted(self._history.items()):
            cnt = max(h["cnt"], 1)
            row = {"name": name, "size": h["size"], "count": h["cnt"]}
            for stat in ("abs", "pos", "val", "rms"):
                v = np.asarray(h[stat], np.float64) / cnt
                if stat == "rms":
                    v = np.sqrt(v)
                row[stat] = float(np.mean(v))
            row["min"] = float(np.min(h["min"]))
            row["max"] = float(np.max(h["max"]))
            pca = np.asarray(h["pca"], np.float64).reshape(-1)
            row["pca"] = float(np.mean(pca)) if pca.size else 0.0
            out.append(row)
        return out

    def to_csv(self, path: str):
        rows = self.rows()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            if rows:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
        return path

    def clear(self):
        self._history.clear()


def capture_activations(module: torch.nn.Module, *args, **kwargs):
    """Run ``module(*args, **kwargs)`` with a forward hook on every
    submodule: returns ``(output, {qualified_name: outputs})``, where
    ``outputs`` is the tuple of a submodule's outputs, one per call (flax's
    ``capture_intermediates`` layout; a container that is never called,
    such as a ``ModuleList``, has no entry). Tensors are detached. The
    hooks are removed when the forward ends, also when it raises."""
    acts: Dict[str, tuple] = {}

    def hook(name):
        def record(_mod, _inp, out):
            out = out.detach() if torch.is_tensor(out) else out
            acts[name] = acts.get(name, ()) + (out,)
        return record

    handles = [m.register_forward_hook(hook(name))
               for name, m in module.named_modules() if name]
    try:
        out = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, acts
