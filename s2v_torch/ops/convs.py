"""Convolution and dense weights in PyTorch's layout.

s2v_tpu/ops/convs.py rebuilds torch's ``Conv2d``, ``ConvTranspose2d`` and
``Linear`` (padding arithmetic, ``output_padding``, ``padding_mode``) for
XLA in NHWC/HWIO. The port runs torch's own layers, which define those
semantics, so what it keeps of that module is the mapping between the two
weight layouts: the inverse of s2v_tpu's ``torch_conv_weight_to_hwio`` and
of its dense ``[in, out]`` convention.
"""

from __future__ import annotations

import numpy as np


def conv_weight_from_hwio(w_hwio) -> np.ndarray:
    """HWIO ``[kh, kw, Cin, Cout]`` -> torch ``Conv2d`` OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1)))


def linear_weight_from_dense(w_in_out) -> np.ndarray:
    """Dense ``[in, out]`` -> torch ``Linear`` ``[out, in]``."""
    return np.ascontiguousarray(np.asarray(w_in_out).T)
