"""The whole fine-tune step's share of the H100's float32 peak in the
unprofiled twin of the traced window's profiled steps (4, one pass over
the clip's batches): the plain reference's FLOPs of those steps, each at
its batch's size (``FlopCounterMode`` formulas on the meta device: ENet's forward, VGG16 and
ReconNet on the prediction and the target, the backward to the style
convs; FFTs not counted) over 67 TFLOP/s (f32 without TF32), over the
twin's wall, in %."""

from portbench.core.readers import mfu_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "whole fine-tune step", "train_pairs_per_s"
BASE = "the unprofiled twin's wall: 4 fine-tune steps"


def read(td):
    return mfu_pct(td)
