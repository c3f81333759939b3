"""The device's idle share in the traced window's profiled fine-tune steps
(4, one pass over the batches): 1 less the union of their device
operations' intervals in the profile over the wall of the same steps'
unprofiled twin, in %."""

from portbench.core.readers import idle_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "train_pairs_per_s"
BASE = "the profile's busy time over its unprofiled twin's wall: 4 fine-tune steps"


def read(td):
    return idle_pct(td)
