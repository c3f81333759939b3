"""Face alignment geometry on the host (reference: futils/ffhq_preprocess.py
and futils/alignment_stit.py): the FFHQ oriented quad from 68 landmarks and
its crop adjustment. A handful of floats per frame, so numpy (float64)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_transform(lm: np.ndarray, scale: float = 1.0):
    """68-landmark FFHQ oriented rectangle (alignment_stit.py:116-146).
    Returns (c, x, y)."""
    eye_left = np.mean(lm[36:42], axis=0)
    eye_right = np.mean(lm[42:48], axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    x *= scale
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return c, x, y


def quad_from_cxy(c, x, y) -> np.ndarray:
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y])


def crop_quad_params(quad: np.ndarray, image_size: Tuple[int, int],
                     output_size: int):
    """crop_image's crop + quad adjustment (alignment_stit.py:68-114, padding
    disabled). Returns (crop_box, adjusted_quad); the resample maps the
    adjusted quad (+0.5) in the cropped image to the output square."""
    w, h = image_size
    quad = quad.copy()
    x = (quad[3] - quad[1]) / 2
    qsize = np.hypot(*x) * 2
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        quad -= crop[0:2]
    else:
        crop = (0, 0, w, h)
    return crop, quad + 0.5
