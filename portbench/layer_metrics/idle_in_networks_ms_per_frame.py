"""The device's idle time while the host was inside a ``net.*`` span, in ms
per output frame: the unprofiled twin's idle time (its wall less the
profile's busy time) times the share of the profile's idle time (the gaps
between its busy intervals) whose midpoint falls inside a ``net.*`` span
(``core/program_trace.py``). The profiler slows the host's operator
dispatch more than plain Python, so the profile's split leans toward the
networks; the profile's own split is printed beside it."""

from portbench.core.program_trace import idle_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "device_trace", "device", "infer_fps"
BASE = ("the twin's idle time by the profile's split of its idle gaps (midpoint inside a "
        "net.* span); the profiler's dispatch cost leans the split toward the networks")


def read(td):
    return idle_ms_per_frame(td, "networks")
