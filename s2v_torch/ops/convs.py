"""Convolution and dense weights in PyTorch's layout.

s2v_tpu/ops/convs.py rebuilds torch's ``Conv2d``, ``ConvTranspose2d`` and
``Linear`` (padding arithmetic, ``output_padding``, ``padding_mode``) for
XLA in NHWC/HWIO. The port runs torch's own layers, which define those
semantics, so what it keeps of that module is the mapping between the
weight layouts: the inverses of s2v_tpu's ``torch_conv_weight_to_hwio``, of
its transposed-conv HWOI and conv1d ``[k, in, out]`` layouts, and of its
dense ``[in, out]`` convention.
"""

from __future__ import annotations

import numpy as np


def conv_weight_from_hwio(w_hwio) -> np.ndarray:
    """HWIO ``[kh, kw, Cin, Cout]`` -> torch ``Conv2d`` OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1)))


def conv_transpose_weight_from_hwoi(w_hwoi) -> np.ndarray:
    """s2v_tpu's ``ConvTranspose`` ``[kh, kw, Cout, Cin]`` -> torch
    ``ConvTranspose2d`` ``[Cin, Cout, kh, kw]``."""
    return np.ascontiguousarray(np.transpose(np.asarray(w_hwoi), (3, 2, 0, 1)))


def conv1d_weight_from_kio(w_kio) -> np.ndarray:
    """s2v_tpu's conv1d ``[k, Cin, Cout]`` -> torch ``Conv1d`` ``[Cout, Cin, k]``."""
    return np.ascontiguousarray(np.transpose(np.asarray(w_kio), (2, 1, 0)))


def linear_weight_from_dense(w_in_out) -> np.ndarray:
    """Dense ``[in, out]`` -> torch ``Linear`` ``[out, in]``."""
    return np.ascontiguousarray(np.asarray(w_in_out).T)
