"""The port's Step-1 detectors against s2v_tpu's on the same weights and
inputs, f32 on the CPU: S3FD (full width: it has no width knob) on 128^2
frames, FAN with one hourglass module on 128^2 crops (the module count is
the only knob; 2DFAN4 stacks four of the same module).

The decodes are argmaxes, which near-ties make discontinuous, so the tests
hold them in two parts:
- the network outputs (softmaxed cls maps, reg maps, heatmaps) within
  1e-4 absolute, relative to the output's scale where it exceeds 1 (f32,
  conv summation order);
- the decodes on identical inputs, the JAX model's outputs fed to both
  decodes: argmax indices, kept masks and landmarks exactly; box
  coordinates, which go through exp, within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import fan as t_fan
from s2v_torch.models import s3fd as t_s3fd
from s2v_torch.utils import weights as TW
from s2v_tpu.models import fan as j_fan
from s2v_tpu.models import s3fd as j_s3fd
from s2v_tpu.utils import weights as JW
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def s3fd_run():
    rng = np.random.RandomState(0)
    v = random_variables(j_s3fd.S3FD(), (1, 128, 128, 3), seed=20)
    x = (rng.rand(2, 128, 128, 3) * 255 - 110).astype(np.float32)
    outs = [tuple(np.asarray(t) for t in o) for o in jax.jit(j_s3fd.S3FD().apply)(v, x)]
    port = load(t_s3fd.S3FD(), TW.s3fd_from_jax(v))
    with torch.no_grad():
        touts = port(to_nchw(x))
    return v, outs, touts


def nchw_outs(outs):
    return [(to_nchw(c), to_nchw(r)) for c, r in outs]


def test_s3fd_matches_jax(s3fd_run):
    _, outs, touts = s3fd_run
    assert len(touts) == 6
    for (c, r), (tc, tr) in zip(outs, touts):
        close(tc.numpy().transpose(0, 2, 3, 1), c)
        close(tr.numpy().transpose(0, 2, 3, 1), r)


def test_s3fd_decodes_match_jax_on_identical_inputs(s3fd_run):
    _, outs, _ = s3fd_run
    jb, js = j_s3fd.decode_all([tuple(map(jnp.asarray, o)) for o in outs])
    tb, ts = t_s3fd.decode_all(nchw_outs(outs))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    jbest, jvalid = j_s3fd.best_boxes([tuple(map(jnp.asarray, o)) for o in outs])
    tbest, tvalid = t_s3fd.best_boxes(nchw_outs(outs))
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ts.argmax(1).numpy(), np.asarray(js).argmax(1))


@pytest.mark.parametrize("iou", [0.3, 0.6])
def test_nms_fixed_matches_jax(iou):
    """Clustered boxes with distinct scores, so the top-k order is defined."""
    rng = np.random.RandomState(1)
    centers = rng.rand(6, 2) * 200
    boxes = np.concatenate([np.repeat(centers, 8, 0) + rng.randn(48, 2) * 6,
                            np.repeat(centers, 8, 0) + 40 + rng.randn(48, 2) * 6], 1)
    scores = rng.permutation(48).astype(np.float32) / 48 + 0.01
    want = j_s3fd.nms_fixed(jnp.asarray(boxes, jnp.float32), jnp.asarray(scores),
                            iou_thresh=iou)
    got = t_s3fd.nms_fixed(torch.tensor(boxes, dtype=torch.float32),
                           torch.from_numpy(scores), iou_thresh=iou)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].sum() < 32


def test_s3fd_converter_roundtrip_and_reference_names(s3fd_run):
    v, _, _ = s3fd_run
    sd = numpy_sd(load(t_s3fd.S3FD(), TW.s3fd_from_jax(v)).state_dict())
    assert_same_tree(JW.convert_s3fd(sd), v)
    for k in ("conv1_1.weight", "fc6.bias", "conv3_3_norm.weight",
              "conv3_3_norm_mbox_conf.weight", "conv7_2_mbox_loc.bias"):
        assert k in sd, k
    assert sd["conv3_3_norm_mbox_conf.weight"].shape[0] == 4


@pytest.fixture(scope="module")
def fan_run():
    rng = np.random.RandomState(2)
    model = j_fan.FAN(num_modules=1)
    v = random_variables(model, (1, 128, 128, 3), seed=21)
    x = rng.rand(2, 128, 128, 3).astype(np.float32)
    hm = np.asarray(jax.jit(model.apply)(v, x))
    port = load(t_fan.FAN(num_modules=1), TW.fan_from_jax(v))
    with torch.no_grad():
        thm = port(to_nchw(x)).numpy()
    return v, hm, thm


def test_fan_matches_jax(fan_run):
    _, hm, thm = fan_run
    assert thm.shape == (2, 68, 32, 32)
    close(thm.transpose(0, 2, 3, 1), hm)


def test_fan_heatmap_decode_matches_jax_on_identical_inputs(fan_run):
    _, hm, _ = fan_run
    rng = np.random.RandomState(3)
    centers = (rng.rand(2, 2) * 100 + 50).astype(np.float32)
    scales = (rng.rand(2) + 0.5).astype(np.float32)
    # peaks on the border rows/columns, where the +-0.25 step is skipped
    hm = hm.copy()
    hm[0, 0, 5, 0] = hm[0, 1, 31, 7] = hm[1, 2, 0, 0] = 50.0
    want = j_fan.heatmaps_to_landmarks(jnp.asarray(hm), jnp.asarray(centers),
                                       jnp.asarray(scales))
    got = t_fan.heatmaps_to_landmarks(to_nchw(hm), torch.from_numpy(centers),
                                      torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fan_crop_and_box_geometry_match_jax():
    rng = np.random.RandomState(4)
    images = (rng.rand(3, 90, 110, 3) * 255).astype(np.float32)
    boxes = np.array([[10, 12, 70, 80], [-20, -5, 60, 50], [50, 40, 130, 120]], np.float32)
    jc, js = j_fan.box_to_center_scale(jnp.asarray(boxes))
    tc, ts = t_fan.box_to_center_scale(torch.from_numpy(boxes))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for got, want in zip(t_fan._crop_bounds(tc, ts), j_fan._crop_bounds(jc, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = j_fan.crop_faces_batched(jnp.asarray(images), jc, js, resolution=64)
    got = t_fan.crop_faces_batched(to_nchw(images), tc, ts, resolution=64)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-6)


def test_fan_converter_roundtrip_and_reference_names(fan_run):
    v, _, _ = fan_run
    sd = numpy_sd(load(t_fan.FAN(num_modules=1), TW.fan_from_jax(v)).state_dict())
    sd = {k: a for k, a in sd.items() if not k.endswith("num_batches_tracked")}
    assert_same_tree(JW.convert_fan(sd, num_modules=1), v)
    full = set(t_fan.FAN().state_dict())  # 2DFAN4.pth's keys
    for k in ("conv1.bias", "bn1.running_var", "conv2.downsample.0.running_mean",
              "conv2.downsample.2.weight", "m0.b1_4.bn1.weight", "m3.b2_plus_1.conv3.weight",
              "top_m_3.conv1.weight", "bn_end3.running_mean", "l3.weight", "bl2.weight",
              "al2.bias"):
        assert k in full, k
    assert "bl3.weight" not in full and "conv3.downsample.0.weight" not in full
