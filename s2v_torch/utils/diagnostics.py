"""Training observability (reference: arcface utils/utils_logging.py
AverageMeter and utils_callbacks.py CallBackLogging samples/sec;
s2v_tpu/utils/diagnostics.py): a running mean and JSON-line throughput
logs. s2v_tpu's per-layer ``Diagnostic`` is not ported yet."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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
    writes a line at any step (a run's last)."""

    def __init__(self, log_path: Optional[str] = None, every: int = 50):
        self.log_path = log_path
        self.every = every
        self._t0 = time.time()
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
        dt = max(time.time() - self._t0, 1e-9)
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
        self._t0 = time.time()
        self._samples = 0
        self.loss.reset()
        self._last_step = step
        return record
