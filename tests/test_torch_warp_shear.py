"""The port's ``affine_warp_shear`` (config ``model.approx_warp``) against
s2v_tpu's, f32 on the CPU, on the cases of tests/test_warp_shear.py: an
axis-aligned scale and translation, a linear ramp under three rotations,
small rotations of smooth content, the ``inverse`` flag over a batch of two,
and a crop mostly off the source (zero outside its footprint); plus a
uint8 input (returned as f32), 4 channels through a 512^2 output (the
shape of the mouth tail's paste), and a crop whose first column maps more
than the frame's width outside it, where s2v_tpu's approximation breaks
down (its window origins clip at -W) and the port breaks down alike. The
two run the same arithmetic in f32 with the interpolation matmul at full
precision: tolerance 2e-3 on values up to 255 (summation order). And the
approximation itself, held to the exact ``affine_warp`` as
tests/test_warp_shear.py holds s2v_tpu's: over 45 dB on smooth content,
within 5e-2 on a linear ramp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.ops.warp import affine_warp, affine_warp_shear
from s2v_tpu.ops.warp import affine_warp_shear as j_affine_warp_shear
from test_warp_shear import _interior_mask, _psnr, _similarity, _smooth
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


ATOL = 2e-3


# one compile per shape, a quarter of the cost of running it op by op
j_shear = jax.jit(j_affine_warp_shear, static_argnums=(2, 3))


def both(img, mats, out_hw, inverse=False):
    """(port NHWC, jax NHWC) of the same NHWC images and [N, 2, 3] maps."""
    want = np.asarray(j_shear(jnp.asarray(img), jnp.asarray(mats), tuple(out_hw), inverse))
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(img).transpose(0, 3, 1, 2)))
    got = affine_warp_shear(x, torch.from_numpy(np.asarray(mats)), out_hw, inverse=inverse)
    return got.numpy().transpose(0, 2, 3, 1), want


CASES = {
    "axis_aligned": lambda: (_smooth(96, 128)[None], _similarity(0.0, 1.7, 12.3, -4.5)[None],
                             (160, 144)),
    "ramp_3": lambda: (ramp(), _similarity(3.0, 1.2, 5.0, -3.0)[None], (128, 128)),
    "ramp_-9": lambda: (ramp(), _similarity(-9.0, 1.2, 5.0, -3.0)[None], (128, 128)),
    "ramp_17": lambda: (ramp(), _similarity(17.0, 1.2, 5.0, -3.0)[None], (128, 128)),
    "smooth_2": lambda: (_smooth(128, 128)[None], _similarity(2.0, 0.9, 4.0, 2.0)[None],
                         (128, 128)),
    "smooth_8": lambda: (_smooth(128, 128)[None], _similarity(8.0, 0.9, 4.0, 2.0)[None],
                         (128, 128)),
    "off_source": lambda: (np.full((1, 32, 32, 1), 200.0, np.float32),
                           _similarity(0.0, 1.0, 24.0, 24.0)[None], (32, 32)),
    # a crop twice the frame's span whose first column maps 496 px left of
    # the frame: past the -W the group windows can reach, where s2v_tpu's
    # warp is no approximation (its window origins clip); the port keeps that
    "out_of_domain": lambda: (
        _smooth(256, 256)[None],
        np.asarray([[0.5, 0.0, 248.0], [0.0, 0.5, 120.0]], np.float32)[None], (512, 512)),
    "rgba_512": lambda: (np.concatenate([_smooth(96, 112), np.ones((96, 112, 1), np.float32)],
                                        -1)[None],
                         _similarity(-4.0, 0.19, 30.0, 25.0)[None], (512, 512)),
}


def ramp(h=128, w=128):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xs, ys, 0.3 * xs + 0.7 * ys], -1)[None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_shear_warp_matches_jax(case):
    img, mats, out_hw = CASES[case]()
    got, want = both(img.astype(np.float32), mats.astype(np.float32), out_hw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 1.0


def test_shear_warp_inverse_flag_and_batch_match_jax():
    imgs = np.stack([_smooth(64, 64), _smooth(64, 64)])
    fwd = np.stack([_similarity(4.0, 1.1, 3.0, -2.0), _similarity(-6.0, 0.8, -1.0, 5.0)])
    inv = np.stack([np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2] for m in fwd]).astype(
        np.float32)
    a, want_a = both(imgs, fwd, (64, 64))
    b, want_b = both(imgs, inv, (64, 64), inverse=True)
    np.testing.assert_allclose(a, want_a, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b, want_b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(a, b, atol=2e-2)


def test_shear_warp_of_uint8_returns_float32():
    img = (_smooth(48, 48) * 0.9).astype(np.uint8)[None]
    mats = _similarity(5.0, 1.1, 2.0, 1.0)[None]
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    got = affine_warp_shear(x, torch.from_numpy(mats), (48, 48))
    assert got.dtype == torch.float32
    want = np.asarray(j_shear(jnp.asarray(img), jnp.asarray(mats), (48, 48), False))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta", [2.0, 5.0, 8.0])
def test_shear_warp_approximates_the_exact_warp(theta):
    img = _smooth(128, 128)[None]
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    mats = torch.from_numpy(_similarity(theta, 0.9, 4.0, 2.0)[None])
    exact = affine_warp(x, mats, (128, 128)).numpy().transpose(0, 2, 3, 1)[0]
    approx = affine_warp_shear(x, mats, (128, 128)).numpy().transpose(0, 2, 3, 1)[0]
    m = _interior_mask(exact) & _interior_mask(approx)
    assert _psnr(exact, approx, m) > 45.0
    lin = ramp()
    xr = torch.from_numpy(np.ascontiguousarray(lin.transpose(0, 3, 1, 2)))
    exact = affine_warp(xr, mats, (128, 128)).numpy().transpose(0, 2, 3, 1)[0]
    approx = affine_warp_shear(xr, mats, (128, 128)).numpy().transpose(0, 2, 3, 1)[0]
    m = _interior_mask(exact) & _interior_mask(approx)
    assert np.abs(exact - approx)[m].max() < 5e-2
