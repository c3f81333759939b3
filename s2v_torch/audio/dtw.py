"""Audio similarity search, a copy of s2v_tpu/audio/dtw.py (reference:
inference.py:414-468 find_best_audio — picks the database wav with the
smallest fastdtw distance to the source wav).

``fastdtw`` implements the Salvador & Chan multilevel approximation the
reference's dependency provides: recursively coarsen by 2x, solve, then
refine within a radius-constrained band. Distances are computed with a
banded dynamic program in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _band_dtw(a: np.ndarray, b: np.ndarray,
              window: Optional[Dict[int, Tuple[int, int]]] = None
              ) -> Tuple[float, List[Tuple[int, int]]]:
    """DTW restricted to a per-row column window; full DTW when None."""
    n, m = len(a), len(b)
    inf = np.inf
    cost: Dict[Tuple[int, int], float] = {(-1, -1): 0.0}
    back: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def cells():
        if window is None:
            for i in range(n):
                yield i, 0, m - 1
        else:
            for i in range(n):
                lo, hi = window.get(i, (0, m - 1))
                yield i, lo, hi

    for i, lo, hi in cells():
        for j in range(lo, hi + 1):
            d = abs(float(a[i]) - float(b[j]))
            best = inf
            arg = None
            for prev in ((i - 1, j), (i, j - 1), (i - 1, j - 1)):
                c = cost.get(prev, inf)
                if c < best:
                    best = c
                    arg = prev
            if arg is None:
                continue
            cost[(i, j)] = best + d
            back[(i, j)] = arg

    path = []
    cur = (n - 1, m - 1)
    while cur != (-1, -1):
        path.append(cur)
        cur = back.get(cur, (-1, -1))
    path.reverse()
    return cost.get((n - 1, m - 1), inf), [p for p in path if p != (-1, -1)]


def _expand_window(path: Sequence[Tuple[int, int]], n: int, m: int,
                   radius: int) -> Dict[int, Tuple[int, int]]:
    window: Dict[int, Tuple[int, int]] = {}
    for (i, j) in path:
        for di in range(-radius, radius + 1):
            for ii in (2 * i + k for k in range(2)):
                row = ii + di
                if 0 <= row < n:
                    lo = max(0, 2 * (j - radius))
                    hi = min(m - 1, 2 * (j + radius) + 1)
                    if row in window:
                        lo = min(lo, window[row][0])
                        hi = max(hi, window[row][1])
                    window[row] = (lo, hi)
    return window


def fastdtw(a: np.ndarray, b: np.ndarray, radius: int = 1) -> float:
    """Approximate DTW distance (Salvador & Chan FastDTW)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    min_size = radius + 2

    def rec(a, b):
        n, m = len(a), len(b)
        if n <= min_size or m <= min_size:
            return _band_dtw(a, b)
        half_a = (a[: 2 * (n // 2)].reshape(-1, 2)).mean(1)
        half_b = (b[: 2 * (m // 2)].reshape(-1, 2)).mean(1)
        _, path = rec(half_a, half_b)
        window = _expand_window(path, n, m, radius)
        return _band_dtw(a, b, window)

    dist, _ = rec(a, b)
    return float(dist)


def find_best_audio(source_wav: np.ndarray,
                    database: Dict[str, np.ndarray],
                    downsample: int = 64) -> Tuple[str, float]:
    """inference.py:414-468: the database entry with the smallest fastdtw
    distance to the source. Wavs are decimated first (the reference runs
    fastdtw on raw 16 kHz samples, which is O(N) per pair via the multilevel
    scheme; decimation keeps the host cost sane at identical ranking)."""
    src = source_wav[::downsample]
    best_name, best_dist = "", np.inf
    for name, wav in database.items():
        d = fastdtw(src, wav[::downsample])
        if d < best_dist:
            best_name, best_dist = name, d
    return best_name, best_dist
