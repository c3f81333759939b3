"""``train/gan.py`` d_step, R1 steps included: the mean of its
synchronised spans over the traced window, outside the profiled
pairs and their twin."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "trainer (train/gan.py)", "train_pairs_per_s"
BASE = "every d_step of the traced window outside the profiled pairs and their twin"


def read(td):
    spans = [s for s in (td.spans.records if td.spans else []) if s.name in ("d_step", "d_step_r1")]
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
