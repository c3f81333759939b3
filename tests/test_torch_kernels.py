"""The port's kernels (s2v_torch.ops.kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; that version is held
against s2v_tpu's XLA twins (fused_bias_leaky_relu_ref, upfirdn2d_ref) and
the Pallas kernels run in interpret mode, on the same numpy inputs, in f32
with atol 1e-5. tests/test_torch_cuda.py holds the CUDA kernels against the
plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from s2v_torch.ops.kernels import fused_bias_leaky_relu, launch_counts, upfirdn2d
from s2v_tpu.ops.pallas.fused_act import (fused_bias_leaky_relu as fused_pallas,
                                          fused_bias_leaky_relu_ref)
from s2v_tpu.ops.pallas.upfirdn2d import upfirdn2d_pallas, upfirdn2d_ref
from test_torch_cuda import CASES, blur_kernel

ATOL = 1e-5  # f32, same arithmetic up to summation order


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_plain_matches_xla(up, down, pad, taps):
    rng = np.random.RandomState(1)
    k = blur_kernel(taps, up)
    x = rng.randn(2, 13, 11, 5).astype(np.float32)  # NHWC
    want = np.asarray(upfirdn2d_ref(jnp.asarray(x), k, up, down, pad))
    got = upfirdn2d(_nchw(x), k, up, down, pad).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_plain_matches_pallas_interpret(up, down, pad, taps):
    rng = np.random.RandomState(2)
    k = blur_kernel(taps, up)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k, up, down, pad))
    got = upfirdn2d(_nchw(x), k, up, down, pad).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (3, 24)])
def test_fused_act_plain_matches_xla_and_pallas(shape):
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)  # channels last, as s2v_tpu
    b = rng.randn(shape[-1]).astype(np.float32)
    want = np.asarray(fused_bias_leaky_relu_ref(jnp.asarray(x), jnp.asarray(b)))
    with pltpu.force_tpu_interpret_mode():
        want_p = np.asarray(fused_pallas(jnp.asarray(x), jnp.asarray(b)))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    got = np.moveaxis(fused_bias_leaky_relu(xt, torch.from_numpy(b)).numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_p, rtol=0, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    before = launch_counts()
    x = torch.randn(1, 4, 8, 8)
    fused_bias_leaky_relu(x, torch.zeros(4))
    upfirdn2d(x, blur_kernel([1, 3, 3, 1]), pad=(1, 2))
    assert launch_counts() == before


def test_wrappers_refuse_other_devices():
    x = torch.randn(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError):
        fused_bias_leaky_relu(x, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        upfirdn2d(x, blur_kernel([1, 3, 3, 1]))
