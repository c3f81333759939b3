"""FAN landmark helpers. The FAN model itself is not ported yet; the slice
takes 68-point landmarks from its caller."""

from __future__ import annotations

import numpy as np


def lm68_to_lm5(lm68: np.ndarray) -> np.ndarray:
    """[..., 68, 2] -> [..., 5, 2] in the RetinaFace / arcface template order
    (left eye, right eye, nose tip, left mouth corner, right mouth corner):
    eye = centroid of its 6-point contour, nose = point 30, mouth corners =
    points 48 and 54."""
    lm68 = np.asarray(lm68)
    return np.stack([lm68[..., 36:42, :].mean(axis=-2),
                     lm68[..., 42:48, :].mean(axis=-2),
                     lm68[..., 30, :], lm68[..., 48, :], lm68[..., 54, :]],
                    axis=-2)
