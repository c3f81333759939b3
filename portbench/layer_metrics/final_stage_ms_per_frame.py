"""The final stage (``pipeline/enhance.py`` ``FaceEnhancer``: RetinaFace
on the 2x frame, GPEN-BFR-2048, RealESRNet x2, ParseNet, the composite),
the ``final_enhancer`` hook's synchronised spans per output frame outside the
profiled requests."""

from portbench.core.readers import spans_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "final stage", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"


def read(td):
    return spans_ms_per_unit(td, ("final_enhancer",))
