"""A frozen module's forward replayed from CUDA graphs.

Where a network's ops are many and small, the host's dispatch of each op
sets the pace and the card idles between them. ``Replay(module)`` issues
the whole forward as one graph launch instead: one graph per key (the
inputs' shapes, dtypes and devices, the CUDA autocast state and the TF32
flags), captured at the key's first call and replayed at every later one.

- The module's first call runs eagerly while the port's own kernel launch
  counters (``kernel.launch.*``, ``s2v_torch.utils.trace``) are watched. A
  module that launched one is declined and stays eager: the launch counts
  and the benchmark's kernel rooflines read each eager call.
- A capture runs two eager forwards on a side stream, then captures a
  third, each under the call's autocast with autocast's cast cache off
  (a cached weight cast is freed when the caller's autocast exits, under
  the graph that reads it) and under the call's TF32 and precision
  settings as they stand (``full_f32`` and the like, set at the call
  site). Each graph keeps its own memory pool.
- A replay copies the inputs into the graph's own tensors and returns the
  graph's outputs (a tensor or a tuple of them, as ``forward`` returns):
  the same tensors at every call of that key. Consume them before the next
  call of the key, or clone them.

Only for a module none of whose parameters learns, called on inputs that
need no gradient. Span ``graph.capture`` holds each capture and
``graph.replay`` each replay, both tagged with ``tag``; a profiler's trace
links a replayed kernel to no host operation (it carries no ``External
id``). ``forward_from(module, replay)`` routes the module's calls to a
``Replay`` inside a block, through the module's own ``__call__`` and its
hooks.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn as nn

from s2v_torch.utils import trace

LAUNCHES = "kernel.launch."


def _launches() -> Dict[str, int]:
    return {k: v for k, v in trace.counters().items() if k.startswith(LAUNCHES)}


def _autocast_state() -> tuple:
    return torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda")


class Replay:
    """``module``'s forward replayed from CUDA graphs (the module docstring);
    ``declined`` once its first call launched a kernel of the port's own."""

    def __init__(self, module: nn.Module, tag: Optional[str] = None):
        self.module = module
        self.tag = tag
        self.graphs: Dict[tuple, tuple] = {}
        self.declined: Optional[bool] = None  # None until the first call

    def _forward(self, *args):
        return type(self.module).forward(self.module, *args)

    def __call__(self, *args):
        if self.declined is None:
            before = _launches()
            out = self._forward(*args)
            self.declined = _launches() != before
            return out
        if self.declined:
            return self._forward(*args)
        key = (tuple((tuple(a.shape), a.dtype, a.device) for a in args), _autocast_state(),
               torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if key not in self.graphs:
            with trace.span("graph.capture", self.tag):
                self.graphs[key] = self._capture(args)
        graph, inputs, out = self.graphs[key]
        with trace.span("graph.replay", self.tag):
            for mine, a in zip(inputs, args):
                mine.copy_(a)
            graph.replay()
        return out

    def _capture(self, args) -> tuple:
        enabled, dtype = _autocast_state()
        inputs = tuple(a.detach().clone() for a in args)

        def under_call_state():
            return torch.autocast("cuda", dtype=dtype, enabled=enabled, cache_enabled=False)

        with torch.cuda.device(inputs[0].device), torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), under_call_state():
                for _ in range(2):
                    self._forward(*inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph), under_call_state():
                out = self._forward(*inputs)
        return graph, inputs, out


@contextlib.contextmanager
def forward_from(module: nn.Module, replay: Optional[Replay]):
    """``module``'s calls go to ``replay`` inside (none given: unchanged)."""
    if replay is None:
        yield
        return
    module.forward = replay
    try:
        yield
    finally:
        del module.forward
