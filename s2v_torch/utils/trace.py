"""Spans and counters of the port, on one host clock.

``span(name, tag=None)`` is a context manager and a decorator. Each span
appends one ``Record`` to a bounded in-memory ring when it ends: its name,
its tag, ``time.perf_counter()`` at its start and end, its id, its parent
span's id and a request id. A span opened with no span open on its thread
starts a new request id; the spans opened inside it inherit it. Parents
are kept per thread. The ring holds ``RING`` records and counts the ones it
drops (``dropped``).

While a ``torch.profiler`` is collecting, a span also enters
``torch.profiler.record_function(name)``, so that it lands in the
profiler's trace as an annotation on the timeline of the device work it
launched; the span's interval holds its annotation's. Without a profiler
no ``record_function`` is built: a span costs one ``perf_counter`` pair and
one append. Spans never synchronise the card, never hold a tensor and never
sit inside a module's ``forward``.

``count(name, n=1)`` keeps plain integer totals (``counters``): the
kernels' launches (``kernel.launch.<kernel>``), the artifact cache's hits,
misses and bytes (``cache.*``), the kernel builds (``kernel.build``), FAN's
calls under cuDNN's autotuner (``conv.timed.fan``), the frames the ENet
fine-tune step trained (``ft.frames``).

``write_chrome(path)`` writes the ring and the counters as a Chrome trace
in the time base of the profiler's own export (microseconds since
``baseTimeNanoseconds``), so that it opens in Perfetto beside a
``torch.profiler`` trace of the same process. The ``infer`` and ``train``
commands write one under ``--trace_out FILE``.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

RING = 2 ** 16
# the trace base of the profiler's Chrome export (libkineto's
# ChromeTraceBaseTime): the epoch floored to intervals of this many seconds
_BASE_INTERVAL_S = 7889238

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


class Record(NamedTuple):
    id: int
    name: str
    tag: Optional[str]
    start: float          # perf_counter seconds
    end: float
    parent: Optional[int]  # the id of the span open when this one started
    request: int
    thread: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_tables: List[Dict[str, int]] = []  # each thread's counters
_lock = threading.Lock()
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """``with span("net.gpen"):`` or ``@span("step6.synthesize")``; after
    the ``with`` block, ``.record`` holds the span's ``Record``."""

    __slots__ = ("name", "tag", "record", "_open")

    def __init__(self, name: str, tag: Optional[str] = None):
        self.name, self.tag = name, tag
        self.record: Optional[Record] = None

    def __enter__(self) -> "span":
        stack = _stack()
        parent, request = stack[-1] if stack else (None, None)
        sid = next(_ids)
        if request is None:
            request = next(_requests)
        stack.append((sid, request))
        start = _clock()
        annotation = None
        if _profiling():
            annotation = record_function(self.name)
            annotation.__enter__()
        self._open = (sid, parent, request, annotation, start)
        return self

    def __exit__(self, *exc) -> bool:
        sid, parent, request, annotation, start = self._open
        if annotation is not None:
            annotation.__exit__(*exc)
        end = _clock()
        _stack().pop()
        self.record = Record(sid, self.name, self.tag, start, end, parent, request,
                             threading.get_ident())
        global _dropped
        with _lock:
            if len(_ring) == RING:
                _dropped += 1
            _ring.append(self.record)
        return False

    def __call__(self, fn):
        name, tag = self.name, self.tag

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, tag):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``. Each thread adds to a table of its
    own, so counting takes no lock (it runs at every kernel launch)."""
    try:
        table = _local.counters
    except AttributeError:
        table = _local.counters = {}
        with _lock:
            _tables.append(table)
    table[name] = table.get(name, 0) + n


def counter(name: str) -> int:
    """Counter ``name``'s total over every thread."""
    return sum(table.get(name, 0) for table in list(_tables))


def counters() -> Dict[str, int]:
    """Every counter's total over every thread."""
    out: Dict[str, int] = {}
    for table in list(_tables):
        for name, n in dict(table).items():
            out[name] = out.get(name, 0) + n
    return out


def records() -> List[Record]:
    """The ring's records, oldest end first."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Records the ring dropped since the last ``reset``."""
    return _dropped


def reset(names=None) -> None:
    """Zero the counters ``names`` (a collection of names); with none given,
    empty the ring, zero its drop count and every counter."""
    global _dropped
    with _lock:
        for table in _tables:
            for name in list(table) if names is None else names:
                table.pop(name, None)
        if names is None:
            _ring.clear()
            _dropped = 0


def _epoch_offset_s() -> float:
    """Seconds to add to a ``perf_counter`` reading to get the Unix time:
    the narrowest of a few paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1] / 1e9


def write_chrome(path: str) -> str:
    """The ring (one complete event per record, its tag, ids and request in
    ``args``) and the counters (one counter event each, at the time of
    writing) as a Chrome trace; ``ts`` in microseconds since
    ``baseTimeNanoseconds``, as ``torch.profiler`` exports them. Returns
    ``path``."""
    offset = _epoch_offset_s()
    now = time.time()
    base_ns = int(now) // _BASE_INTERVAL_S * _BASE_INTERVAL_S * 1_000_000_000
    base_s = base_ns / 1e9
    pid = os.getpid()

    def us(t: float) -> float:
        return (t + offset - base_s) * 1e6

    events = [dict(ph="X", cat="s2v_span", name=r.name, pid=pid, tid=r.thread,
                   ts=us(r.start), dur=(r.end - r.start) * 1e6,
                   args=dict(tag=r.tag, id=r.id, parent=r.parent, request=r.request))
              for r in records()]
    totals = counters()
    at = (now - base_s) * 1e6
    events += [dict(ph="C", cat="s2v_counter", name=k, pid=pid, tid=0, ts=at, args={k: v})
               for k, v in sorted(totals.items())]
    with open(path, "w") as f:
        json.dump(dict(displayTimeUnit="ms", baseTimeNanoseconds=base_ns, traceEvents=events,
                       counters=totals, dropped=dropped()), f)
    return path
