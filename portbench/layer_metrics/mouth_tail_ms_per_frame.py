"""The mouth tail (``pipeline/restoration.py`` ``MouthRestorer``:
RetinaFace, GFPGAN, ParseNet's mouth mask, the Laplacian blend), the
``mouth_restorer`` hook's synchronised spans per output frame outside the
profiled requests."""

from portbench.core.readers import spans_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "mouth tail", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"


def read(td):
    return spans_ms_per_unit(td, ("mouth_restorer",))
