"""S3FD box post-processing. The S3FD detector itself is not ported yet;
the slice takes boxes from its caller."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_and_smooth_boxes(boxes: np.ndarray, image_hw: Tuple[int, int],
                         pads: Tuple[int, int, int, int] = (0, 20, 0, 0),
                         smooth: bool = True) -> np.ndarray:
    """face_detect post-processing (inference_utils.py:130-144): floor the
    boxes (x1, y1, x2, y2), apply pads (top, bottom, left, right), clip to
    the frame, then the reference's 5-frame smoothing. Returns [N, 4] int."""
    h, w = image_hw
    pady1, pady2, padx1, padx2 = pads
    b = np.floor(np.asarray(boxes, np.float32)).astype(np.int64)
    out = np.stack([np.maximum(b[:, 0] - padx1, 0), np.maximum(b[:, 1] - pady1, 0),
                    np.minimum(b[:, 2] + padx2, w), np.minimum(b[:, 3] + pady2, h)],
                   axis=1)
    if smooth:
        out = smooth_boxes(out, 5)
    return out


def smooth_boxes(boxes: np.ndarray, window: int = 5) -> np.ndarray:
    """inference_utils.py:101-108: forward-looking ``window``-frame mean,
    recentred on the last frames near the tail, assigned in place into an
    int array (later windows read smoothed rows; values truncate)."""
    cur = np.array(boxes, np.int64)
    n = len(cur)
    for i in range(n):
        win = cur[n - window:] if i + window > n else cur[i:i + window]
        cur[i] = np.trunc(win.mean(axis=0))
    return cur
