"""The device time between the networks, in ms per output frame of the traced
window's profiled request: every operation whose host operation starts
inside ``infer.run`` and outside every ``net.*`` span (warps, pastes,
blends, resizes, copies, the mel; ``core/program_trace.py``). With the per-
network readers it adds up to the device time that the program's spans
hold; what none holds is printed beside it."""

from portbench.core.program_trace import GLUE, device_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "device_trace", "networks", "infer_fps"
BASE = "output frames of the profiled request: device time in infer.run outside every net.* span"


def read(td):
    return device_ms_per_frame(td, (GLUE,))
