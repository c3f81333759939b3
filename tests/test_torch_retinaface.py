"""The port's RetinaFace against s2v_tpu's on the same weights and inputs,
f32 on the CPU: cfg_re50 (a full ResNet50 body: the JAX module has no width
knob) on a 64x96 input and cfg_mnet on a 96x64 one, both with random
weights at working scales (tests/torch_parity.py).

- Network outputs (loc, softmaxed conf, landms) within 2e-4 absolute, as
  tests/test_retinaface.py holds s2v_tpu to the reference, relative to the
  output's scale where it exceeds 1 (f32, conv summation order).
- The anchors exactly, at square and non-square sizes (both sides compute
  them in float64 and round once).
- The decodes on identical inputs within 1e-6 relative (boxes go through
  exp); ``detect_faces``'s argmax and its valid flags exactly, with one
  frame under the threshold.
- The converters both ways: the port's state_dict through s2v_tpu's
  ``convert_retinaface`` / ``convert_retinaface_mnet`` gives back the flax
  tree, and ``load_reference`` takes a RetinaFace-R50.pth state_dict (with
  its DataParallel ``module.`` prefix) strictly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import retinaface as t_rf
from s2v_torch.utils import weights as TW
from s2v_tpu.models import retinaface as j_rf
from s2v_tpu.utils import weights as JW
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables

CFGS = {"re50": (j_rf.RetinaFace, t_rf.RetinaFace, JW.convert_retinaface, (64, 96), 60),
        "mnet": (j_rf.retinaface_mnet, t_rf.retinaface_mnet, JW.convert_retinaface_mnet,
                 (96, 64), 61)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module", params=list(CFGS))
def run(request):
    j_make, t_make, convert, (h, w), seed = CFGS[request.param]
    rng = np.random.RandomState(seed)
    v = random_variables(j_make(), (1, h, w, 3), seed=seed)
    x = (rng.rand(2, h, w, 3) * 255 - 117).astype(np.float32)
    want = [np.array(o) for o in jax.jit(j_make().apply)(v, x)]
    port = load(t_make(), TW.retinaface_from_jax(v))
    with torch.no_grad():
        got = [o.numpy() for o in port(to_nchw(x))]
    return dict(name=request.param, v=v, want=want, got=got, port=port, convert=convert,
                hw=(h, w))


def test_retinaface_matches_jax(run):
    h, w = run["hw"]
    n = sum(2 * -(-h // s) * -(-w // s) for s in t_rf.STEPS)
    for got, want, k in zip(run["got"], run["want"], (4, 2, 10)):
        assert got.shape == want.shape == (2, n, k)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(run["got"][1].sum(-1), 1.0, rtol=1e-6)


def test_retinaface_converter_roundtrip_and_reference_names(run):
    sd = numpy_sd(run["port"].state_dict())
    assert_same_tree(run["convert"](sd), run["v"])
    for k in ("fpn.output1.0.weight", "fpn.merge2.1.running_var", "ssh3.conv7x7_3.1.bias",
              "ssh1.conv5X5_1.0.weight", "ClassHead.2.conv1x1.bias",
              "LandmarkHead.0.conv1x1.weight"):
        assert k in sd, k
    assert sd["ClassHead.0.conv1x1.weight"].shape[0] == 4  # 2 anchors x 2 classes
    body = ("body.layer2.0.downsample.0.weight" if run["name"] == "re50"
            else "body.stage1.1.3.weight")
    assert body in sd


def test_load_reference_takes_a_retinaface_checkpoint(run):
    """A checkpoint as retinaface_detection.py finds it: every key under
    ``module.``, BN counters included; the geometry read from the keys."""
    sd = {f"module.{k}": v.clone() for k, v in run["port"].state_dict().items()}
    model = t_rf.retinaface_arch({k[len("module."):]: v for k, v in sd.items()})
    assert model.backbone == ("resnet50" if run["name"] == "re50" else "mobilenet0.25")
    TW.load_reference(model, sd)
    for k, v in run["port"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (250, 333), (256, 256), (1024, 1024)])
def test_prior_box_matches_jax(hw):
    np.testing.assert_array_equal(t_rf.prior_box(hw).numpy(), j_rf.prior_box(hw))


def _outputs(rng, b, hw):
    """Random head outputs over every anchor of ``hw``; the face score of
    frame 0 stays under 0.9 everywhere, frame 1 has one anchor above."""
    n = len(j_rf.prior_box(hw))
    loc = rng.randn(b, n, 4).astype(np.float32)
    ldm = rng.randn(b, n, 10).astype(np.float32)
    face = rng.uniform(0.0, 0.85, (b, n)).astype(np.float32)
    face[1:, rng.randint(n)] = 0.97
    conf = np.stack([1 - face, face], -1)
    return loc, conf, ldm


@pytest.mark.parametrize("hw", [(96, 64), (256, 256)])
def test_decodes_and_detect_faces_match_jax(hw):
    rng = np.random.RandomState(62)
    loc, conf, ldm = _outputs(rng, 3, hw)
    priors = j_rf.prior_box(hw)
    for t_fn, j_fn, arr in ((t_rf.decode_boxes, j_rf.decode_boxes, loc),
                            (t_rf.decode_landms, j_rf.decode_landms, ldm)):
        want = np.asarray(j_fn(jnp.asarray(arr), jnp.asarray(priors), hw))
        got = t_fn(torch.from_numpy(arr), torch.from_numpy(priors), hw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(hw))
    want = j_rf.detect_faces(tuple(map(jnp.asarray, (loc, conf, ldm))), hw)
    got = t_rf.detect_faces(tuple(map(torch.from_numpy, (loc, conf, ldm))), hw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6 * max(hw))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].tolist() == [False, True, True]


def test_detect_faces_on_the_network_outputs_matches_jax(run):
    """The JAX model's outputs into both decoders: the same anchor wins."""
    want = j_rf.detect_faces(tuple(map(jnp.asarray, run["want"])), run["hw"])
    got = t_rf.detect_faces(tuple(map(torch.from_numpy, run["want"])), run["hw"])
    close(got[0].numpy(), want[0])
    close(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
