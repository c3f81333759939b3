"""The fine-tune step's own span (``ft.step``, ``train/finetune_enet.py``):
the mean of its host-clock records over the traced window, outside the
profiled steps and their twin. The program's spans never synchronise and
the benchmark waits for the card after each step, so a record is the
host's time to issue the step, which holds the device's time only where
the launch queue fills and makes the host wait."""

from portbench.core.finetune_trace import step_ms

UNIT, SOURCE, LAYER, MOVES = ("ms", "program_span", "fine-tune step (train/finetune_enet.py)",
                              "train_pairs_per_s")
BASE = "every ft.step of the traced window outside the profiled steps and their twin"


def read(td):
    return step_ms(td)
