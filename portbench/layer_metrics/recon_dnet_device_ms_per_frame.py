"""ReconNet's and DNet's device time (Steps 2 and 3, which the artifact
cache skips in dub), in ms per output frame of the traced window's
profiled request: the device time of every operation whose host operation
starts inside a ``net.recon`` or ``net.dnet`` span (the program's
annotations, core/program_trace.py)."""

from portbench.core.program_trace import device_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "device_trace", "networks", "infer_fps"
BASE = "output frames of the profiled request: device time under net.recon and net.dnet"


def read(td):
    return device_ms_per_frame(td, ("net.recon", "net.dnet"))
