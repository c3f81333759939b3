"""``LipSyncPipeline.run`` outside every stage: each request's span less
the spans of the stages ``run`` calls in it (clip read, cache loads and
writes, mel, the writer, the mux, and the client's reading of the output),
per output frame of the traced window outside the profiled request and its twin."""

from portbench.core.readers import spans_ms_per_unit

UNIT, SOURCE, LAYER, MOVES = "ms/frame", "program_span", "run, cache and I/O", "infer_fps"
BASE = "output frames of the traced window outside the profiled request and its twin"
STAGES = ("extract_landmarks", "ffhq_crop", "extract_coeffs", "stabilize", "enhance_reference",
          "synthesize")


def read(td):
    inside = spans_ms_per_unit(td, STAGES, parent="request")
    if inside is None:
        return None
    return spans_ms_per_unit(td, ("request",)) - inside
