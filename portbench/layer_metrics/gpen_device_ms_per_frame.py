"""GPEN-BFR-2048's device time (the final stage's generator), in ms per output
frame of the traced window's profiled request: the device time of every
operation whose host operation starts inside a ``net.gpen`` span (the
program's annotations, core/program_trace.py)."""

from portbench.core.program_trace import device_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "device_trace", "networks", "infer_fps"
BASE = "output frames of the profiled request: device time under net.gpen"


def read(td):
    return device_ms_per_frame(td, ("net.gpen",))
