"""The artifact cache's hits over its lookups (``cache.hit`` and
``cache.miss`` spans of ``s2v_torch.utils.trace``, one per stage looked up)
in the traced window's requests outside the profiled request and its twin,
in %."""

from portbench.core.program_trace import count, window_records

UNIT, SOURCE, LAYER, MOVES = "%", "program_span", "run, cache and I/O", "infer_fps"
BASE = "cache lookups of the traced window outside the profiled request and its twin"


def read(td):
    records = window_records(td)
    if records is None:
        return None
    hits, misses = count(records, "cache.hit"), count(records, "cache.miss")
    return 100.0 * hits / (hits + misses) if hits + misses else None
