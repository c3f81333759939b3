"""The fine-tune step's backward (span ``ft.backward``: from the loss
through ReconNet, VGG16 and ENet's upsampling convs to the style convs'
gradients): its device time in ms per frame trained in the traced window's
profiled steps, from every device operation whose host operation starts
inside that span. Autograd's own thread launches these while the step's
thread waits inside the span; the labelling goes by time, so they are the
span's (core/finetune_trace.py)."""

from portbench.core.finetune_trace import device_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = ("ms/frame", "device_trace",
                              "fine-tune step (train/finetune_enet.py)", "train_pairs_per_s")
BASE = "frames of the profiled steps: device time under ft.backward"


def read(td):
    return device_ms_per_frame(td, "ft.backward")
