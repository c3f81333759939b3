"""The numbers that decide ``correct``, and the shape records that the
FLOP counts rebuild calls from."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np


def frames(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """uint8 frames of the program against the reference's: the mean
    absolute gap in gray levels over every subpixel, the share of subpixels
    off by more than 8 levels, and the widest gap."""
    if got.shape != want.shape:
        return dict(frame_mean_abs=math.inf, frame_share_off_8=1.0, frame_max_abs=255.0)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return dict(frame_mean_abs=float(d.mean()), frame_share_off_8=float((d > 8).mean()),
                frame_max_abs=float(d.max()))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between two sets of per-leaf norms: |got - want| over
    the larger of the reference's norm of that leaf and of the median leaf
    (some gradients are all but zero). A leaf that ``got`` lacks reads NaN."""
    median = float(np.median([want[k] for k in want]))
    return {k: abs(got.get(k, math.nan) - want[k]) / max(want[k], median, 1e-30)
            for k in (want if keep is None else keep)}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> tuple:
    """The worst leaf's gap (``leaf_gaps``). Returns (gap, leaf); a NaN gap
    is the worst."""
    worst, leaf = -1.0, None
    for k, gap in leaf_gaps(got, want, keep).items():
        if not gap <= worst:
            worst, leaf = gap, k
    return (math.inf, None) if leaf is None else (worst, leaf)


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The median of the leaves' gaps (``leaf_gaps``); NaN where a leaf is
    NaN."""
    gaps = list(leaf_gaps(got, want).values())
    if not gaps:
        return math.inf
    return math.nan if any(g != g for g in gaps) else float(np.median(gaps))


def relative_gap(got: Iterable[float], want: Iterable[float]) -> float:
    """The largest |got - want| / |want| over pairs."""
    out = 0.0
    for g, w in zip(got, want):
        gap = abs(g - w) / max(abs(w), 1e-30)
        if not gap <= out:
            out = gap
    return out


def spec(torch, args, kwargs) -> tuple:
    """A hashable record of a call's arguments: tensors by shape and dtype."""
    def one(v):
        if torch.is_tensor(v):
            return ("T", tuple(v.shape), str(v.dtype))
        if isinstance(v, (list, tuple)):
            return (type(v).__name__, tuple(one(x) for x in v))
        if isinstance(v, (int, float, str, bool, type(None))):
            return v
        return repr(v)

    return one(tuple(args)), tuple(sorted((k, one(v)) for k, v in kwargs.items()))


def rebuild(torch, record, device="meta"):
    """Arguments from a ``spec`` record: float tensors in float32 (the
    reference's precision) on ``device``, other tensors in their dtype."""
    def one(v):
        if isinstance(v, tuple) and v and v[0] == "T":
            dtype = getattr(torch, v[2].split(".")[-1])
            if dtype.is_floating_point:
                dtype = torch.float32
            return torch.empty(v[1], dtype=dtype, device=device)
        if isinstance(v, tuple) and v and v[0] in ("list", "tuple"):
            items = [one(x) for x in v[1]]
            return items if v[0] == "list" else tuple(items)
        return v

    args, kwargs = record
    return one(args), {k: one(v) for k, v in kwargs}
