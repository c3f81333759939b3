"""The bound arithmetic of K1-K3 against PERF.md section 6's bound column
(ms, NVIDIA H100: 3.35 TB/s, 67 TFLOP/s), and its reading of the shapes
that the profiler records."""

from __future__ import annotations

import pytest

from portbench.core import peaks

F32, BF16 = 4, 2
BLUR4 = (4, 4)


@pytest.mark.parametrize("shape, esize, want", [
    ((1, 32, 2048, 2048), BF16, 0.160), ((4, 128, 512, 512), F32, 0.321),
    ((3, 64, 120, 120), F32, 0.0066), ((7, 32, 512, 512), BF16, 0.0701)])
def test_k1(shape, esize, want):
    assert peaks.k1_bound_s(shape, esize) * 1e3 == pytest.approx(want, rel=6e-3, abs=5e-5)


@pytest.mark.parametrize("shape, esize, want", [
    ((4, 128, 512, 512), F32, 0.481), ((4, 128, 512, 512), BF16, 0.240),
    ((3, 64, 120, 120), F32, 0.0099)])
def test_k2(shape, esize, want):
    assert peaks.k2_bound_s(shape, esize, with_b=False) * 1e3 == pytest.approx(
        want, rel=6e-3, abs=5e-5)


@pytest.mark.parametrize("shape, esize, up, pads, want", [
    ((1, 16, 2049, 2049), BF16, 1, (1, 1, 1, 1), 0.080),
    ((4, 64, 513, 513), F32, 1, (1, 1, 1, 1), 0.161),
    ((4, 64, 512, 512), F32, 1, (2, 2, 2, 2), 0.161),
    ((3, 64, 120, 120), F32, 1, (2, 2, 2, 2), 0.0067),
    ((3, 128, 40, 40), F32, 1, (2, 2, 2, 2), 0.0015),
    ((7, 32, 513, 513), BF16, 1, (1, 1, 1, 1), 0.070),
    ((7, 16, 512, 512), BF16, 1, (2, 2, 2, 2), 0.035),
    ((7, 3, 256, 256), BF16, 2, (2, 1, 2, 1), 0.0041)])
def test_k3(shape, esize, up, pads, want):
    got = peaks.k3_bound_s(shape, esize, *BLUR4, up, 1, pads) * 1e3
    assert got == pytest.approx(want, rel=6e-3, abs=5e-5)


def test_bounds_from_profiler_arguments():
    """The shapes, types and scalars of a Chrome trace's operator event."""
    k1 = {"Input Dims": [[4, 128, 512, 512], [128], [], []],
          "Input type": ["float", "float", "Scalar", "Scalar"]}
    assert peaks.op_bound_s(peaks.K1, k1) == peaks.k1_bound_s((4, 128, 512, 512), F32)
    k2 = {"Input Dims": [[4, 128, 512, 512], [4, 128, 512, 512], [128], [], []],
          "Input type": ["c10::BFloat16", "c10::BFloat16", "float", "Scalar", "Scalar"]}
    assert peaks.op_bound_s(peaks.K2, k2) == peaks.k2_bound_s((4, 128, 512, 512), BF16, True)
    k3 = {"Input Dims": [[7, 3, 256, 256], [], [], [], [], [], [], [], [], []],
          "Input type": ["c10::BFloat16", "GenericList", "Int", "Int", "Int", "Int", "Int",
                         "Int", "Int", "Int"],
          "Concrete Inputs": ["", "[0.0625, 0.1875]", "4", "4", "2", "1", "2", "1", "2", "1"]}
    assert peaks.op_bound_s(peaks.K3, k3) == peaks.k3_bound_s((7, 3, 256, 256), BF16, 4, 4, 2,
                                                               1, (2, 1, 2, 1))
    assert peaks.op_bound_s(peaks.K3, {**k3, "Concrete Inputs": []}) is None
