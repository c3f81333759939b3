"""The whole work's share of the H100's peaks in the unprofiled twin of
the traced window's profiled work (one whole request): the plain reference's
FLOPs at the shapes the program ran (``FlopCounterMode`` on the meta
device), each network's over the peak of the precision it ran in (989
TFLOP/s bf16, 67 TFLOP/s f32 without TF32), over the twin's wall, in %."""

from portbench.core.readers import mfu_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "whole request", "infer_fps"
BASE = "the unprofiled twin's wall: one whole request"


def read(td):
    return mfu_pct(td)
