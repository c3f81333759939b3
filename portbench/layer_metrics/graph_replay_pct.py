"""The network calls (``net.*`` spans of ``s2v_torch.utils.trace``) that
replayed a CUDA graph (a ``graph.replay`` span directly inside,
``s2v_torch.utils.graphs``) over all network calls, in the traced window's
requests outside the profiled request and its twin, in %. Nothing to read
from a program without ``s2v_torch.utils.graphs``."""

import importlib.util

from portbench.core.program_trace import NET, window_records

UNIT, SOURCE, LAYER, MOVES = "%", "program_span", "final stage", "infer_fps"
BASE = "network calls of the traced window outside the profiled request and its twin"


def read(td):
    records = window_records(td)
    if records is None or importlib.util.find_spec("s2v_torch.utils.graphs") is None:
        return None
    nets = {r.id for r in records if r.name.startswith(NET)}
    replayed = {r.parent for r in records if r.name == "graph.replay"}
    return 100.0 * len(nets & replayed) / len(nets) if nets else None
