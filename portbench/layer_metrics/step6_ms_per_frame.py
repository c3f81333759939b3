"""Step 6 (``LipSyncPipeline.synthesize``) less its two hooks: the
reference faces' sweep, crop, mask, ENet/LNet and paste; synchronised
spans per output frame of the traced window outside the profiled request
and its twin."""

from portbench.core.readers import spans_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "Step 6 synthesis", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"


def read(td):
    whole = spans_ms_per_unit(td, ("synthesize",))
    if whole is None:
        return None
    hooks = spans_ms_per_unit(td, ("mouth_restorer", "final_enhancer"), parent="synthesize")
    return whole - (hooks or 0.0)
