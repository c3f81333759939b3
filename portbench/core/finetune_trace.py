"""What the readers of the fine-tune step's own spans share
(``s2v_torch.train.finetune_enet``: ``ft.step`` with ``ft.enet``,
``ft.perceptual``, ``ft.identity``, ``ft.backward`` and ``ft.adam`` inside).

From the profile (``device_trace``): a device operation belongs to the
innermost ``ft.*`` annotation that holds the start of the host operation
with the same ``External id`` (``program_trace.Innermost``, by time alone,
whatever the thread). The backward's operators run on autograd's own
thread while the step's thread waits inside ``ft.backward``, so by time
they fall to ``ft.backward``. Operations inside ``ft.step`` and outside
its children (the batch's layout copies, L1, the loss's sum, the
gradients' reset) stay ``ft.step``'s. A CUDA graph's kernels (the
replayed LNet) carry no ``External id``: each goes to the owner of the
device operation before it, as the step's work runs on one stream in the
order the host issued it.

From the ring (``program_span``): the program's ``ft.step`` records that
start inside the benchmark's own ``step`` spans, which leave out set-up,
the profiled steps and their twin.

Each function returns None where there is nothing to read: a program
without these spans (the parent of the change that added them), no
profile, no span of the kind asked for.
"""

from __future__ import annotations

import bisect
import re
import sys
from typing import Dict, Optional

from portbench.core.program_trace import Innermost, ring
from portbench.core.trace import TraceData

FT = re.compile(r"ft\.")


def device_split(profile) -> Optional[Dict[Optional[str], float]]:
    """Device seconds of the profile by the innermost ``ft.*`` span that
    launched them, None for what none holds (printed once, with the
    profile's whole device time, on standard error)."""
    if profile is None:
        return None
    if not hasattr(profile, "ft_device_split"):
        profile.ft_device_split = _device_split(profile)
    return profile.ft_device_split


def _device_split(profile):
    spans = [(ts, ts + dur, name) for name, ts, dur in profile.annotations if FT.match(name)]
    if not spans:
        return None
    inner = Innermost(spans)
    start: Dict[object, float] = {}
    for _, ts, _, args in profile.host:
        eid = args.get("External id")
        if eid is not None and (eid not in start or ts < start[eid]):
            start[eid] = ts
    out: Dict[Optional[str], float] = {}
    owner = None
    for _, _, dur, eid in sorted(profile.device, key=lambda d: d[1]):
        if eid is not None:
            owner = inner.at(start[eid]) if eid in start else None
        out[owner] = out.get(owner, 0.0) + dur / 1e6
    total = sum(out.values())
    shares = ", ".join(f"{k} {v:.6f}" for k, v in sorted(out.items(), key=lambda kv: -kv[1]))
    print(f"device seconds of the profile by fine-tune span: {shares}; all {total:.6f}",
          file=sys.stderr)
    return out


def device_ms_per_frame(td: TraceData, name: str) -> Optional[float]:
    """The profiled steps' device time owned by span ``name``, in ms per
    frame trained; None where that span owns none."""
    split = device_split(td.profile)
    if not split or name not in split or td.profile.units <= 0:
        return None
    return 1e3 * split[name] / td.profile.units


def step_ms(td: TraceData) -> Optional[float]:
    """The mean host-clock length of the program's ``ft.step`` records that
    start inside the benchmark's ``step`` spans."""
    trace = ring()
    if trace is None or td.spans is None:
        return None
    steps = sorted((s.start, s.end) for s in td.spans.records if s.name == "step")
    if not steps:
        return None
    starts = [a for a, _ in steps]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= steps[i][1]

    got = [r.end - r.start for r in trace.records() if r.name == "ft.step" and inside(r.start)]
    return 1e3 * sum(got) / len(got) if got else None
