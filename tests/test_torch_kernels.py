"""The port's kernels (s2v_torch.ops.kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; that version is held
against s2v_tpu's XLA twins (fused_bias_leaky_relu_ref, upfirdn2d_ref) and
the Pallas kernels run in interpret mode, on the same numpy inputs, in f32
with atol 1e-5. The gradients go through the port's autograd Functions
(whose CPU path calls the plain versions, so the Functions' wiring is what
is tested) against jax.vjp; gradcheck and gradgradcheck in f64 (fast mode:
random projections of the Jacobians) hold the Functions' first and second
derivatives against finite differences.
tests/test_torch_cuda.py holds the CUDA kernels against the plain versions
on the card.
"""

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_bwd,
                                   fused_bias_leaky_relu_bwd_plain, launch_counts, upfirdn2d)
from s2v_torch.ops.kernels.fused_act import FusedActBackward
from s2v_tpu.ops.pallas.fused_act import (fused_bias_leaky_relu as fused_pallas,
                                          fused_bias_leaky_relu_ref)
from s2v_tpu.ops.pallas.upfirdn2d import upfirdn2d_pallas, upfirdn2d_ref
from test_torch_cuda import CASES, blur_kernel
from torch_parity import one_torch_thread

ATOL = 1e-5  # f32, same arithmetic up to summation order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


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
    x = torch.randn(1, 4, 8, 8, requires_grad=True)
    y = upfirdn2d(fused_bias_leaky_relu(x, torch.zeros(4)), blur_kernel([1, 3, 3, 1]),
                  pad=(1, 2))
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    gx.square().sum().backward()
    assert launch_counts() == before


def test_wrappers_refuse_other_devices():
    x = torch.randn(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError):
        fused_bias_leaky_relu(x, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        upfirdn2d(x, blur_kernel([1, 3, 3, 1]))


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (3, 24)])
def test_fused_act_backward_matches_pallas_vjp(shape):
    """K2's plain version and the autograd Function's gradient against
    jax.vjp of the Pallas kernel (whose backward is the Pallas _bwd_kernel)
    in interpret mode."""
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)  # channels last, as s2v_tpu
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fused_pallas, jnp.asarray(x), jnp.asarray(b))
        want_dx, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    def t(a):
        return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))

    dx = fused_bias_leaky_relu_bwd_plain(t(g), t(out))
    np.testing.assert_allclose(np.moveaxis(dx.numpy(), 1, -1), want_dx, rtol=0, atol=ATOL)
    xt, bt = t(x).requires_grad_(), torch.from_numpy(b).requires_grad_()
    gx, gb = torch.autograd.grad(fused_bias_leaky_relu(xt, bt), (xt, bt), t(g))
    np.testing.assert_allclose(np.moveaxis(gx.numpy(), 1, -1), want_dx, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gb.numpy(), want_db, rtol=0, atol=1e-4)  # a sum of ~10^2


def test_fused_act_double_backward_matches_jax():
    """K2 with b (the backward's own backward) against jax.vjp of the XLA
    twin's vjp: the gradient of (dx, dbias) with respect to g."""
    rng = np.random.RandomState(5)
    x, g, gg = (rng.randn(2, 5, 6, 8).astype(np.float32) for _ in range(3))
    b, ggb = (rng.randn(8).astype(np.float32) for _ in range(2))
    out, vjp = jax.vjp(fused_bias_leaky_relu_ref, jnp.asarray(x), jnp.asarray(b))
    _, vjp2 = jax.vjp(vjp, jnp.asarray(g))
    (want,) = vjp2((jnp.asarray(gg), jnp.asarray(ggb)))

    def t(a):
        return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))

    got = fused_bias_leaky_relu_bwd(t(gg), t(out), torch.from_numpy(ggb))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=0, atol=ATOL)
    gt = t(g).requires_grad_()
    dx, dbias = FusedActBackward.apply(gt, t(out), 0.2, 2 ** 0.5)
    (got2,) = torch.autograd.grad((dx, dbias), gt, (t(gg), torch.from_numpy(ggb)))
    np.testing.assert_allclose(np.moveaxis(got2.numpy(), 1, -1), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_grad_matches_jax_vjp(up, down, pad, taps):
    """The Function's input gradient (K3 with the flipped FIR, up and down
    swapped and the gradient's pads) against jax.vjp of upfirdn2d_ref, on a
    non-square input with odd sides (each axis takes its own pads, and the
    floor division of a down=2 drops a row and a column)."""
    rng = np.random.RandomState(6)
    k = blur_kernel(taps, up)
    x = rng.randn(2, 13, 11, 5).astype(np.float32)
    out, vjp = jax.vjp(lambda a: upfirdn2d_ref(a, k, up, down, pad), jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_()
    (got,) = torch.autograd.grad(upfirdn2d(xt, k, up, down, pad), xt, _nchw(g))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (4, 6)])
def test_fused_act_gradcheck_f64(shape):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(*shape, dtype=torch.float64, generator=gen, requires_grad=True)
    b = torch.randn(shape[1], dtype=torch.float64, generator=gen, requires_grad=True)
    assert gradcheck(fused_bias_leaky_relu, (x, b), fast_mode=True)
    assert gradgradcheck(fused_bias_leaky_relu, (x, b), fast_mode=True)


@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_gradcheck_f64(up, down, pad, taps):
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1, 2, 7, 6, dtype=torch.float64, generator=gen, requires_grad=True)
    k = blur_kernel(taps, up)

    def f(a):
        return upfirdn2d(a, k, up, down, pad)

    assert gradcheck(f, (x,), fast_mode=True)
    assert gradgradcheck(f, (x,), fast_mode=True)
