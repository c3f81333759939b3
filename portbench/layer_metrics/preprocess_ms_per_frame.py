"""Steps 1-3 and 5 (``pipeline/inference.py``; Step 5 in
``pipeline/enhance.py``): the synchronised spans of ``extract_landmarks``,
``ffhq_crop``, ``extract_coeffs``, ``stabilize`` and ``enhance_reference``
called by ``run`` itself (not the sweep inside ``synthesize``), per output
frame of the traced window. What the artifact cache skips."""

from portbench.core.readers import spans_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "pipeline Steps 1-3 and 5", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"
STEPS = ("extract_landmarks", "ffhq_crop", "extract_coeffs", "stabilize", "enhance_reference")


def read(td):
    return spans_ms_per_unit(td, STEPS, parent="request")
