"""K1 (``s2v::fused_act_fwd``) in the profiled part of the traced window: the sum of
each call's least time (PERF.md section 6's arithmetic, ``core/peaks.py``,
from the shapes the profiler recorded) over the device time of the kernels
those calls launched, in %."""

from portbench.core.readers import kernel_roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels (ops/kernels)", "train_pairs_per_s"
BASE = "every K1 call in the profiled part"


def read(td):
    return kernel_roofline(td, "s2v::fused_act_fwd")
