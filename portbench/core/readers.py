"""What the per-layer readers share: span sums per unit of work, a
kernel's share of its roofline, the device's idle share and the whole
work's share of the peaks. Each returns None where the trace holds nothing
to read."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.core.peaks import op_bound_s
from portbench.core.trace import TraceData

# the kernel names of each operator, for device events the profiler did not
# link to the operator that launched them
KERNEL_NAMES = {"s2v::fused_act_fwd": ("fused_scalar", "fused_vec"),
                "s2v::fused_act_bwd": ("bwd_scalar", "bwd_vec"),
                "s2v::upfirdn2d": ("upfirdn2d_strips", "upfirdn2d_direct")}


def spans_ms_per_unit(td: TraceData, names: Iterable[str], parent=...) -> Optional[float]:
    names = tuple(names)
    if td.spans is None or td.units <= 0 or not any(s.name in names for s in td.spans.records):
        return None
    return sum(td.spans.total(n, parent) for n in names) * 1e3 / td.units


def kernel_roofline(td: TraceData, op: str) -> Optional[float]:
    """Sum of the least times of every call of operator ``op`` in the
    profiled part over the device time of the kernels those calls launched,
    in %."""
    p = td.profile
    if p is None:
        return None
    calls = [h for h in p.ops(op) if p.start_us <= h[1] <= p.end_us]
    if not calls:
        return None
    bounds = [op_bound_s(op, args) for _, _, _, args in calls]
    if any(b is None for b in bounds):
        return None
    ids = {args.get("External id") for _, _, _, args in calls} - {None}
    linked = [d for d in p.device if d[3] in ids and ids]
    if len(linked) != len(calls):
        linked = [d for d in p.device if d[0].split("<")[0].split("(")[0].strip()
                  .split(" ")[-1] in KERNEL_NAMES[op]]
    if len(linked) != len(calls):
        return None
    device_s = sum(d[2] for d in linked) / 1e6
    return 100.0 * sum(bounds) / device_s if device_s > 0 else None


def idle_pct(td: TraceData) -> Optional[float]:
    """1 less the profiled work's device busy time over its unprofiled
    twin's wall, in %."""
    p = td.profile
    if p is None or not td.twin_s:
        return None
    return 100.0 * (1.0 - p.busy_s() / td.twin_s)


def mfu_pct(td: TraceData) -> Optional[float]:
    """The twin's work's ideal seconds at the peaks over its wall, in %."""
    if not td.flop_s_at_peak or not td.twin_s:
        return None
    return 100.0 * td.flop_s_at_peak / td.twin_s
