"""The output's writer loop and close (``io.write``) and the mux (``io.mux``),
the program's own spans (``s2v_torch.utils.trace``, host clock,
unsynchronised), per output frame of the traced window outside the profiled
request and its twin."""

from portbench.core.program_trace import seconds, window_records

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "run, cache and I/O", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"


def read(td):
    records = window_records(td)
    if records is None or td.units <= 0 or not any(
            r.name in ("io.write", "io.mux") for r in records):
        return None
    return 1e3 * seconds(records, ("io.write", "io.mux")) / td.units
