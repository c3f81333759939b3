"""The perceptual term's forward in the fine-tune step (span
``ft.perceptual``: VGG16 features 0-22 on the prediction and the target at
224^2): its device time in ms per frame trained in the traced window's
profiled steps, from every device operation whose host operation starts
inside that span (core/finetune_trace.py)."""

from portbench.core.finetune_trace import device_ms_per_frame

UNIT, SOURCE, LAYER, MOVES = ("ms/frame", "device_trace",
                              "fine-tune step (train/finetune_enet.py)", "train_pairs_per_s")
BASE = "frames of the profiled steps: device time under ft.perceptual"


def read(td):
    return device_ms_per_frame(td, "ft.perceptual")
