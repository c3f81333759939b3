"""What the readers of the program's own spans share (``s2v_torch.utils.trace``).

From the profile (``device_trace``): the program's spans are annotations of
the profiled request (a span enters ``record_function`` while a profiler
runs). A device operation belongs to the innermost program span that holds
the start of the host operation with the same ``External id``: a network
(a ``net.*`` span), the glue (inside ``infer.run`` and outside every
network), or nothing (no program span holds it, or the profiler linked it
to no host operation). An idle gap of the device (between the union's busy
intervals) belongs to the program span that holds its midpoint, alike. The
profiler slows the host's operator dispatch more than plain Python, and the
networks dispatch most operators, so the profile's idle time leans toward
the networks.

From the ring (``program_span``): the program's records that start inside
the benchmark's own ``request`` spans, which leave out set-up, the profiled
request and its twin. Both clocks are ``time.perf_counter``. Where the ring
dropped records that may lie in the window, there is nothing to read.

Each function returns None where there is nothing to read: a program
without these spans (the parent of the change that added them), no
profile, no span of the kind asked for.
"""

from __future__ import annotations

import bisect
import re
import sys
from typing import Dict, List, Optional, Tuple

from portbench.core.trace import TraceData

PROGRAM = re.compile(r"(net|infer|step\d|cache|io|audio|setup|kernel|gan|data|engine)\.")
RUN = "infer.run"
NET = "net."
GLUE = "glue"


class Innermost:
    """The innermost of nested intervals [start, end) at a time: the
    intervals swept once into segments, each labelled with the interval
    that started last among those open over it."""

    def __init__(self, intervals: List[Tuple[float, float, str]]):
        events = []
        for i, (a, b, _) in enumerate(intervals):
            if b > a:
                events.append((a, 1, -b, i))
                events.append((b, 0, 0, i))
        events.sort()
        self.times: List[float] = []
        self.labels: List[Optional[str]] = []
        open_: List[int] = []
        for k, (t, kind, _, i) in enumerate(events):
            if kind:
                open_.append(i)
            else:
                open_.remove(i)
            if k + 1 < len(events) and events[k + 1][0] == t:
                continue
            self.times.append(t)
            self.labels.append(intervals[open_[-1]][2] if open_ else None)

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else None


def _labeller(profile):
    """A function from a host time (the trace's us) to a network's span
    name, ``GLUE`` or None; None where the profile holds no program span."""
    spans = [(ts, ts + dur, name) for name, ts, dur in profile.annotations
             if PROGRAM.match(name)]
    if not spans:
        return None
    inner = Innermost(spans)
    runs = Innermost([s for s in spans if s[2] == RUN])

    def label(t: float) -> Optional[str]:
        name = inner.at(t)
        if name is not None and name.startswith(NET):
            return name
        return GLUE if runs.at(t) == RUN else None

    return label


def device_split(profile) -> Optional[Dict[Optional[str], float]]:
    """Device seconds of the profile by owner: each network's span name,
    ``GLUE``, and None for what no program span holds (printed once, with
    the profile's whole device time, on standard error)."""
    if profile is None:
        return None
    if not hasattr(profile, "program_device_split"):
        profile.program_device_split = _device_split(profile)
    return profile.program_device_split


def _device_split(profile):
    label = _labeller(profile)
    if label is None:
        return None
    start: Dict[object, float] = {}
    for _, ts, _, args in profile.host:
        eid = args.get("External id")
        if eid is not None and (eid not in start or ts < start[eid]):
            start[eid] = ts
    out: Dict[Optional[str], float] = {}
    kernels: Dict[tuple, float] = {}
    for name, _, dur, eid in profile.device:
        owner = label(start[eid]) if eid in start else None
        out[owner] = out.get(owner, 0.0) + dur / 1e6
        kernels[owner, name] = kernels.get((owner, name), 0.0) + dur / 1e6
    total = sum(out.values())
    shares = ", ".join(f"{k} {v:.6f}" for k, v in sorted(out.items(), key=lambda kv: -kv[1]))
    print(f"device seconds of the profile by program span: {shares}; all {total:.6f}, "
          f"held by none {100 * out.get(None, 0.0) / total if total else 0.0:.4f}%",
          file=sys.stderr)
    for (owner, name), sec in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {owner}: {sec:.6f} s {name[:90]}", file=sys.stderr)
    return out


def device_ms_per_frame(td: TraceData, names) -> Optional[float]:
    """The device time of the profiled request owned by the spans ``names``
    (network span names or ``GLUE``), in ms per output frame; None where
    none of them owns any."""
    split = device_split(td.profile)
    if not split or td.profile.units <= 0:
        return None
    got = [split[n] for n in names if n in split]
    return 1e3 * sum(got) / td.profile.units if got else None


def idle_split(profile) -> Optional[Dict[str, float]]:
    """The profile's idle seconds (the gaps between its busy intervals,
    inside the profiled region) by the owner of each gap's midpoint:
    ``networks``, ``glue`` and ``other`` (printed once, per output frame,
    on standard error)."""
    if profile is None:
        return None
    if not hasattr(profile, "program_idle_split"):
        profile.program_idle_split = _idle_split(profile)
    return profile.program_idle_split


def _idle_split(profile):
    label = _labeller(profile)
    if label is None:
        return None
    edges = [profile.start_us] + [x for ab in profile.busy_intervals() for x in ab] \
        + [profile.end_us]
    out = dict(networks=0.0, glue=0.0, other=0.0)
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        owner = label((a + b) / 2)
        key = "other" if owner is None else GLUE if owner == GLUE else "networks"
        out[key] += (b - a) / 1e6
    if profile.units > 0:
        raw = ", ".join(f"{k} {1e3 * v / profile.units:.3f}" for k, v in out.items())
        print(f"idle time of the profile by program span, ms a frame: {raw}", file=sys.stderr)
    return out


def idle_ms_per_frame(td: TraceData, key: str) -> Optional[float]:
    """The twin's idle time (its wall less the profile's busy time) times
    the share of the profile's idle time that ``key`` (``networks`` or
    ``glue``) holds, in ms per output frame."""
    p = td.profile
    split = idle_split(p)
    if split is None or not td.twin_s or p.units <= 0:
        return None
    total = sum(split.values())
    if total <= 0:
        return None
    return 1e3 * (td.twin_s - p.busy_s()) * split[key] / total / p.units


def ring():
    """The program's trace module, or None when the program has none."""
    try:
        from s2v_torch.utils import trace
    except ImportError:
        return None
    return trace


def window_records(td: TraceData) -> Optional[list]:
    """The program's records that start inside one of the benchmark's
    ``request`` spans; None without the ring, without such spans, or where
    the ring dropped records that may lie inside them."""
    trace = ring()
    if trace is None or td.spans is None:
        return None
    requests = sorted((s.start, s.end) for s in td.spans.records if s.name == "request")
    if not requests:
        return None
    records = trace.records()
    # the ring drops the oldest ends first: nothing dropped ended after its oldest
    if trace.dropped() and (not records or records[0].end >= requests[0][0]):
        return None
    starts = [a for a, _ in requests]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= requests[i][1]

    return [r for r in records if inside(r.start)]


def count(records: list, name: str) -> int:
    return sum(r.name == name for r in records)


def seconds(records: list, names) -> float:
    return sum(r.end - r.start for r in records if r.name in names)
