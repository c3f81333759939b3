"""The benchmark's fixed yardstick: cell lookup, tracing and its reduction,
peaks and bounds, FLOP counts, comparisons and the inputs made from a seed."""
