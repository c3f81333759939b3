"""The port's last geometry helpers and FAN's depth regressor against
s2v_tpu's, on the CPU:

- ``pipeline/align.py``: ``quad_sample_grid``, ``calc_alignment_coefficients``
  and ``perspective_sample_grid`` (numpy) equal s2v_tpu's bit for bit;
  ``quad_grids_batched`` and ``perspective_grids_batched`` (torch, f32)
  within 1e-6 of s2v_tpu's JAX grids and of the numpy ones; ``warp_by_grid``
  (``F.grid_sample`` on NCHW) within 1e-4 of scale of s2v_tpu's gather-based warp
  on 0..255 images, with a shared grid and with one per image; ``paste_back``
  within 1e-6;
- ``pipeline/face3d_prep.py``: ``umeyama`` (with and without scale, and on
  a reflected point set) and ``estimate_norm`` equal s2v_tpu's within
  1e-12 (the same float64 numpy);
- ``models/resnet.py`` ``ResNetDepth`` (ResNet-152 over 71 channels) from
  s2v_tpu's variables through ``resnet_depth_from_jax`` at 224^2, batch 1:
  within 1e-4 of the JAX output's scale (one module fixture: ResNet-152's
  JAX compile is this file's slowest step; its seconds are printed), its
  keys those of face_detection/models.py's ResNetDepth; at 256^2 the fixed
  7x7 pool takes the top-left window of the 8x8 map.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models.resnet import ResNetDepth as TResNetDepth
from s2v_torch.pipeline import align as TA
from s2v_torch.pipeline import face3d_prep as TP
from s2v_torch.utils.weights import resnet_depth_from_jax
from s2v_tpu.models.resnet import ResNetDepth
from s2v_tpu.pipeline import align as JA
from s2v_tpu.pipeline import face3d_prep as JP
from test_torch_models import close, load, to_nchw
from torch_parity import one_torch_thread, random_variables

RNG = np.random.RandomState(211)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _quads(n, size=96):
    c = size / 2 + RNG.uniform(-6, 6, (n, 1, 2))
    x = RNG.uniform(20, 30, (n, 1, 2)) * np.array([1.0, 0.2])
    y = np.flip(x, -1) * np.array([-1.0, 1.0])
    return np.concatenate([c - x - y, c - x + y, c + x + y, c + x - y], 1)  # nw sw se ne


def _coeffs(n):
    pb = np.array([[0, 0], [0, 63], [63, 63], [63, 0]], np.float64)
    return np.stack([JA.calc_alignment_coefficients(q, pb) for q in _quads(n)])


def test_host_grids_equal_the_jax_package():
    quad = _quads(1)[0]
    np.testing.assert_array_equal(TA.quad_sample_grid(quad, 64, (96, 80)),
                                  JA.quad_sample_grid(quad, 64, (96, 80)))
    pb = np.array([[0, 0], [0, 63], [63, 63], [63, 0]], np.float64)
    cf = TA.calc_alignment_coefficients(quad, pb)
    np.testing.assert_array_equal(cf, JA.calc_alignment_coefficients(quad, pb))
    np.testing.assert_array_equal(TA.perspective_sample_grid(cf, (64, 48), (96, 80)),
                                  JA.perspective_sample_grid(cf, (64, 48), (96, 80)))


def test_batched_grids_match_the_jax_package_and_the_host_grids():
    quads, coeffs = _quads(3), _coeffs(3)
    got = TA.quad_grids_batched(torch.from_numpy(quads), 64, (96, 80)).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.quad_grids_batched(quads, 64, (96, 80))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], TA.quad_sample_grid(quads[1], 64, (96, 80)),
                               rtol=0, atol=1e-6)
    got = TA.perspective_grids_batched(coeffs, (64, 48), (96, 80)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JA.perspective_grids_batched(coeffs, (64, 48), (96, 80))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2], TA.perspective_sample_grid(coeffs[2], (64, 48), (96, 80)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shared", [True, False], ids=["one_grid", "grid_per_image"])
def test_warp_by_grid_and_paste_back_match_the_jax_package(shared):
    images = (RNG.rand(3, 96, 80, 3) * 255).astype(np.float32)
    grid = (TA.quad_sample_grid(_quads(1)[0], 64, (96, 80)) if shared
            else TA.perspective_grids_batched(_coeffs(3), (64, 48), (96, 80)).numpy())
    want = np.asarray(JA.warp_by_grid(jnp.asarray(images), jnp.asarray(grid)))
    got = TA.warp_by_grid(to_nchw(images), torch.from_numpy(grid))
    close(got.numpy().transpose(0, 2, 3, 1), want)
    mask = (RNG.rand(*got.shape) > 0.5).astype(np.float32)
    orig = RNG.rand(*got.shape).astype(np.float32) * 255
    pasted = TA.paste_back(got, torch.from_numpy(mask), torch.from_numpy(orig)).numpy()
    jpasted = JA.paste_back(got.numpy(), mask, orig)
    np.testing.assert_allclose(pasted, np.asarray(jpasted), rtol=0, atol=1e-6)


@pytest.mark.parametrize("estimate_scale", [True, False])
def test_umeyama_matches_the_jax_package(estimate_scale):
    src = RNG.randn(5, 2) * 30 + 50
    for dst in (src @ np.array([[0.8, -0.3], [0.3, 0.8]]) + 7,
                src * np.array([-1.0, 1.0]) + RNG.randn(5, 2),  # a reflection
                RNG.randn(5, 2)):
        np.testing.assert_allclose(TP.umeyama(src, dst, estimate_scale),
                                   JP.umeyama(src, dst, estimate_scale), rtol=0, atol=1e-12)
    same = np.zeros((5, 2))
    assert np.isnan(TP.umeyama(same, same)).all() and np.isnan(JP.umeyama(same, same)).all()


def test_estimate_norm_matches_the_jax_package():
    np.testing.assert_array_equal(TP.ARCFACE_DST, JP.ARCFACE_DST)
    lm = RNG.rand(68, 2) * 100 + 60
    np.testing.assert_allclose(TP.estimate_norm(lm, 224.0), JP.estimate_norm(lm, 224.0),
                               rtol=0, atol=1e-12)
    flat = np.zeros((68, 2))
    np.testing.assert_array_equal(TP.estimate_norm(flat, 224.0), JP.estimate_norm(flat, 224.0))


@pytest.fixture(scope="module")
def depth():
    model = ResNetDepth()
    t = time.perf_counter()
    v = random_variables(model, (1, 224, 224, 71), seed=3)
    x = RNG.uniform(-1, 1, (1, 224, 224, 71)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(v, x))
    print(f"ResNetDepth: JAX compile and forward at 224^2 {time.perf_counter() - t:.1f} s")
    return load(TResNetDepth(), resnet_depth_from_jax(v)), x, want


def test_resnet_depth_matches_jax(depth):
    port, x, want = depth
    with torch.no_grad():
        got = port(to_nchw(x)).numpy()
    assert got.shape == want.shape == (1, 68)
    close(got, want)


def test_resnet_depth_keys_follow_the_reference_and_pool_the_top_left_window(depth):
    port = depth[0]
    keys = port.state_dict().keys()
    assert {"conv1.weight", "bn1.running_var", "layer3.35.conv3.weight",
            "layer4.0.downsample.0.weight", "fc.weight", "fc.bias"} <= keys
    assert not [k for k in keys if k.startswith("backbone.")]
    assert len([k for k in keys if k.endswith(".conv1.weight")]) == 3 + 8 + 36 + 3
    x = torch.from_numpy(RNG.uniform(-1, 1, (1, 71, 256, 256)).astype(np.float32))
    with torch.no_grad():
        feat = port.layer4(port.layer3(port.layer2(port.layer1(port.maxpool(
            torch.relu(port.bn1(port.conv1(x))))))))
        assert feat.shape[-2:] == (8, 8)
        want = port.fc(feat[:, :, :7, :7].mean((2, 3)))
        torch.testing.assert_close(port(x), want, rtol=1e-5, atol=1e-5)
