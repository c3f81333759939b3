"""Per-video artifact cache (reference: temp/<basename>_*.{txt,npy} files,
facing.py:89-198, training.py:397-416; s2v_tpu/utils/cache.py with torch
tensors).

Each expensive pipeline stage's output is cached keyed by (video basename,
stage, parameters-hash) and skipped on re-run unless invalidated
(--re_preprocess: ``refresh=True``). File names are s2v_tpu's for
the same parameters, so either package reads the other's artifacts.

Each lookup is a span of ``s2v_torch.utils.trace``, ``cache.hit`` or
``cache.miss`` tagged with the stage (a miss's compute runs inside it), and
adds to the counters ``cache.hit``, ``cache.miss``, ``cache.bytes_read``
and ``cache.bytes_written``; ``flush`` is span ``cache.flush``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from s2v_torch.utils import trace


def _to_numpy(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _start_host_copy(v):
    """A CUDA tensor's copy into pinned host memory, queued behind the work
    that produces it; the event marks its end. A copy into pageable memory
    would wait for the card's queue to drain. Other values pass as they
    are, with no event."""
    if not (torch.is_tensor(v) and v.is_cuda):
        return v, None
    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
    host.copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class ArtifactCache:
    def __init__(self, directory: str = "temp"):
        self.directory = directory
        # (path, value, events): writes postponed to flush(); see
        # get_or_compute(defer=True)
        self._pending: list = []

    def _path(self, base_name: str, stage: str, params: Optional[dict]) -> str:
        tag = ""
        if params:
            blob = json.dumps(params, sort_keys=True, default=str).encode()
            tag = "_" + hashlib.sha1(blob).hexdigest()[:8]
        return os.path.join(self.directory, f"{base_name}_{stage}{tag}.npz")

    def get_or_compute(self, base_name: str, stage: str,
                       fn: Callable[[], Any], params: Optional[dict] = None,
                       refresh: bool = False, defer: bool = False):
        """Arrays or tensors (or dicts of them) returned by fn are cached as
        .npz; a hit returns numpy arrays.

        ``defer=True`` keeps the cache write off the critical path: a CUDA
        tensor returned by fn starts a non-blocking copy into pinned host
        memory at once, and the .npz write happens at ``flush()``, which
        first waits for that copy, so it has overlapped with the downstream
        stages. The caller receives fn's value unchanged (device tensors
        stay on the device on a miss)."""
        path = self._path(base_name, stage, params)
        if not refresh and os.path.isfile(path):
            with trace.span("cache.hit", stage):
                trace.count("cache.hit")
                trace.count("cache.bytes_read", os.path.getsize(path))
                data = np.load(path, allow_pickle=False)
                keys = sorted(data.files)
                if keys == ["__single__"]:
                    return data["__single__"]
                return {k: data[k] for k in keys}
        with trace.span("cache.miss", stage):
            trace.count("cache.miss")
            out = fn()
            if defer:
                if isinstance(out, dict):
                    copies = {k: _start_host_copy(v) for k, v in out.items()}
                    host = {k: h for k, (h, _) in copies.items()}
                    events = [e for _, e in copies.values()]
                else:
                    host, event = _start_host_copy(out)
                    events = [event]
                self._pending.append((path, host, [e for e in events if e is not None]))
            else:
                self._write(path, out)
            return out

    def _write(self, path: str, out) -> None:
        os.makedirs(self.directory, exist_ok=True)
        # uncompressed: frame stacks compress poorly and the reference's
        # .npy caches are raw too (facing.py:130,195)
        if isinstance(out, dict):
            np.savez(path, **{k: _to_numpy(v) for k, v in out.items()})
        else:
            np.savez(path, __single__=_to_numpy(out))
        trace.count("cache.bytes_written", os.path.getsize(path))

    @trace.span("cache.flush")
    def flush(self) -> None:
        """Write every deferred artifact, each once its host copy is done."""
        pending, self._pending = self._pending, []
        for path, host, events in pending:
            for e in events:
                e.synchronize()
            self._write(path, host)
