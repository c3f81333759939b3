"""The device's idle share in the traced window's profiled work (16 pairs, one with R1):
1 less the union of its device operations' intervals in the profile over
the wall of the same work's unprofiled twin, in %."""

from portbench.core.readers import idle_pct

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "train_pairs_per_s"
BASE = "the profile's busy time over its unprofiled twin's wall: 16 pairs, one with R1"


def read(td):
    return idle_pct(td)
