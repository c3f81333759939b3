"""``s2v_torch.cli.load_models`` in set-up: the process's one
``setup.load_models`` span (``s2v_torch.utils.trace``, host clock): every
checkpoint read from disk, each module built on the card and loaded."""

from portbench.core.program_trace import ring

UNIT, SOURCE, LAYER, MOVES = "s", "program_span", "set-up", "setup_s"
BASE = "the one load_models of the process, in set-up"


def read(td):
    trace = ring()
    if trace is None:
        return None
    loads = [r for r in trace.records() if r.name == "setup.load_models"]
    return loads[0].end - loads[0].start if loads else None
