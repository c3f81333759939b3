"""Spans around calls into the program, the profiled part of a traced run,
and the reduction of both that the per-layer readers share.

Spans are recorded in the traced run only, from the benchmark's own files:
``Spans.wrap`` replaces a method or hook of a program object by one that
synchronises the card, reads the host clock, runs the call inside a
``torch.profiler.record_function`` of the span's name, synchronises and
reads the clock again. The untraced run wraps nothing, and a traced run
switches the spans off (annotations only: no synchronising, no record)
over its profiled part and that part's twin, so that no span holds the
profiler's own cost.

``profiled`` runs ``torch.profiler`` (CPU and CUDA activities, shapes
recorded) over a region of the traced window, writes its Chrome trace
under the temporary directory, reads it back and deletes it. ``Profile``
keeps the device operations (kernels, copies, sets), the host operators
with their shapes and the annotations, in the trace's microseconds. The
profiler slows the host about twofold, so the device's busy time is read
from the profile and its wall from a twin of the profiled work that runs
unprofiled just before it (``TraceData.twin_s``).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
REGION = "portbench.profiled"


def synchronize(torch, device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Span:
    name: str
    start: float   # host seconds (perf_counter)
    end: float
    parent: Optional[str]

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Synchronised host-clock spans; a span's parent is the span open when
    it started (None at the top). While ``active`` is False a span is an
    annotation alone: it neither synchronises nor records."""

    def __init__(self, torch, device="cuda"):
        self.torch, self.device = torch, device
        self.records: List[Span] = []
        self._open: List[str] = []
        self.active = True

    @contextlib.contextmanager
    def __call__(self, name: str):
        torch = self.torch
        if not self.active:
            with torch.profiler.record_function(name):
                yield
            return
        synchronize(torch, self.device)
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
            synchronize(torch, self.device)
        finally:
            self._open.pop()
            self.records.append(Span(name, t0, time.perf_counter(), parent))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.attr`` (a bound method or a callable attribute) by
        one that runs inside span ``name``."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def spanned(*a, **k):
            with self(name):
                return fn(*a, **k)

        setattr(obj, attr, spanned)

    def total(self, name: str, parent=...) -> float:
        """Seconds in spans ``name`` (with that parent, when given)."""
        return sum(s.seconds for s in self.records
                   if s.name == name and (parent is ... or s.parent == parent))


@dataclass
class Profile:
    """The profiled region of a traced run, in the trace's microseconds."""

    start_us: float
    end_us: float
    device: List[Tuple[str, float, float, Optional[int]]]   # (name, ts, dur, external id)
    host: List[Tuple[str, float, float, dict]]       # (name, ts, dur, args)
    annotations: List[Tuple[str, float, float]]      # (name, ts, dur)
    units: float = 0.0                               # frames or pairs inside

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the region."""
        spans = sorted((max(ts, self.start_us), min(ts + dur, self.end_us))
                       for _, ts, dur, _ in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def ops(self, name: str) -> List[Tuple[str, float, float, dict]]:
        return [h for h in self.host if h[0] == name]

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took the most time: [[name, s], ...]."""
        total: Dict[str, float] = {}
        for name, _, dur, _ in self.device:
            total[name] = total.get(name, 0.0) + dur / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, labelled: int = 400) -> List[list]:
        """Idle device time by what the host was doing: each of the
        ``labelled`` longest gaps between device operations gets the name
        of the outermost annotation and the innermost host operation that
        cover its midpoint; the seconds are summed by that name."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for ab in busy for x in ab] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted((ts, ts + dur, name) for name, ts, dur, _ in self.host)
        starts = [h[0] for h in host]
        notes = sorted((ts, ts + dur, name) for name, ts, dur in self.annotations
                       if name != REGION)
        total: Dict[str, float] = {}
        for a, b in gaps[:labelled]:
            mid = (a + b) / 2
            outer = next((n for s, e, n in notes if s <= mid <= e), "outside every span")
            inner = "python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if host[j][1] >= mid:
                    inner = host[j][2]
                    break
            label = f"{outer} / {inner}"
            total[label] = total.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def read_chrome_trace(path: str) -> Profile:
    """The ``REGION`` annotation's interval and every device operation,
    host operation and annotation of a Chrome trace written by
    ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device, host, notes = [], [], []
    region = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, ts, dur, e.get("args", {}).get("External id")))
        elif cat == "user_annotation":
            notes.append((name, ts, dur))
            if name == REGION:
                region = (ts, ts + dur)
        elif cat in HOST_CATS:
            host.append((name, ts, dur, e.get("args", {})))
    if region is None:
        raise RuntimeError(f"{path} has no {REGION} annotation")
    inside = [d for d in device if d[1] < region[1] and d[1] + d[2] > region[0]]
    return Profile(region[0], region[1], inside, host, notes)


@contextlib.contextmanager
def profiled(torch, sink: list, device="cuda"):
    """Profile the body; appends the profiler to ``sink``, for ``read``
    after the window."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    synchronize(torch, device)
    with profile(activities=activities, record_shapes=True) as prof:
        with torch.profiler.record_function(REGION):
            yield
            synchronize(torch, device)
    sink.append(prof)


@contextlib.contextmanager
def timed(torch, sink: list, device="cuda"):
    """The body's wall on the host clock, the card synchronised at both
    edges; appends the seconds to ``sink``."""
    synchronize(torch, device)
    t0 = time.perf_counter()
    yield
    synchronize(torch, device)
    sink.append(time.perf_counter() - t0)


def read(prof, units: float) -> Profile:
    """The ``Profile`` of a finished profiler: its Chrome trace written
    under the temporary directory, read back and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = read_chrome_trace(path)
    finally:
        os.remove(path)
    out.units = units
    return out


@dataclass
class TraceData:
    """What every per-layer reader reads: the traced window's spans, its
    wall and the work outside its profiled part and that part's twin, the
    profile, and the twin's wall."""

    window_s: float
    units: float                      # frames or pairs completed outside the profile and twin
    spans: Spans                      # recorded outside the profile and its twin
    profile: Optional[Profile]
    twin_s: Optional[float] = None    # the profiled work's twin, unprofiled: its wall
    flop_s_at_peak: Optional[float] = None   # the twin's work's ideal seconds

