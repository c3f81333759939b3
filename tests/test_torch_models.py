"""The port's models against s2v_tpu's on the same weights and inputs.

Each model's variables are built in JAX at a slim width (tests/slim_zoo.py
and the ENet geometry of tests/test_pipeline_e2e.py) with random values at
working scales, biases, noise strengths and BatchNorm statistics included so
every path carries signal, converted
with the port's ``*_from_jax`` into the port module (strict load), and run on
the same numpy input in f32 on the CPU. Tolerance: 1e-4 absolute, relative
to the output's scale where it exceeds 1 (f32, conv summation order).

The round-trip tests check the converters the other way: the port's
state_dict through s2v_tpu.utils.weights.convert_* gives back the flax tree.
"""

import numpy as np
import torch
from flax import traverse_util

import jax

from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.utils import weights as TW
from s2v_tpu.models import ENet
from s2v_tpu.models.gpen import FullGenerator
from s2v_tpu.models.parsenet import ParseNet
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.utils import weights as JW
from torch_parity import random_variables

ENET_KW = dict(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
               lnet_base_nc=8, lnet_max_nc=32)
GPEN_KW = dict(size=64, narrow=0.25, channel_multiplier=0.5, style_dim=64, n_mlp=2)
PARSE_KW = dict(base_ch=16, max_ch=32, min_ch=8, res_depth=2)
RRDB_KW = dict(scale=2, num_feat=16, num_block=2, num_grow_ch=8)


def close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def load(module, sd):
    module.load_state_dict(sd)  # strict: every key and shape must match
    return module.eval()


def assert_same_tree(got, want):
    g = traverse_util.flatten_dict(got)
    w = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k], np.float32), w[k], err_msg=str(k))


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_enet_matches_jax():
    rng = np.random.RandomState(0)
    model = ENet(**ENET_KW)
    v = random_variables(model, (1, 80, 16, 1), (1, 96, 96, 6), (1, 96, 96, 3), seed=1)
    mel = rng.randn(2, 80, 16, 1).astype(np.float32)
    face = rng.rand(2, 96, 96, 6).astype(np.float32)
    gt = rng.rand(2, 96, 96, 3).astype(np.float32)
    pred, low = jax.jit(model.apply)(v, mel, face, gt)
    port = load(TENet(**ENET_KW), TW.enet_from_jax(v))
    with torch.no_grad():
        tpred, tlow = port(to_nchw(mel), to_nchw(face), to_nchw(gt))
    close(tlow.numpy().transpose(0, 2, 3, 1), low)
    close(tpred.numpy().transpose(0, 2, 3, 1), pred)


def test_gpen_matches_jax():
    rng = np.random.RandomState(2)
    model = FullGenerator(**GPEN_KW)
    v = random_variables(model, (1, 64, 64, 3), seed=2, equalized=True)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(model.apply)(v, x)
    port = load(TGPEN(**GPEN_KW), TW.gpen_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(x))
    close(got.numpy().transpose(0, 2, 3, 1), want)


def test_parsenet_matches_jax():
    rng = np.random.RandomState(3)
    model = ParseNet(**PARSE_KW)
    v = random_variables(model, (1, 64, 64, 3), seed=3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mask, img = jax.jit(model.apply)(v, x)
    port = load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(v))
    with torch.no_grad():
        tmask, timg = port(to_nchw(x))
    close(tmask.numpy().transpose(0, 2, 3, 1), mask)
    close(timg.numpy().transpose(0, 2, 3, 1), img)


def test_rrdbnet_matches_jax():
    rng = np.random.RandomState(4)
    model = RRDBNet(**RRDB_KW)
    v = random_variables(model, (1, 24, 24, 3), seed=4)
    x = rng.rand(2, 24, 24, 3).astype(np.float32)
    want = jax.jit(model.apply)(v, x)
    port = load(TRRDBNet(**RRDB_KW), TW.rrdbnet_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(x))
    close(got.numpy().transpose(0, 2, 3, 1), want)


def test_enet_roundtrip():
    # s2v_tpu's convert_lnet reads the production decoder depth (9 blocks)
    kw = dict(ENET_KW, lnet_res_blocks=9)
    tree = random_variables(ENet(**kw), (1, 80, 16, 1), (1, 96, 96, 6), (1, 96, 96, 3))
    sd = numpy_sd(load(TENet(**kw), TW.enet_from_jax(tree)).state_dict())
    enet_sd = {k: v for k, v in sd.items() if not k.startswith("low_res.")}
    lnet_sd = {k[len("low_res."):]: v for k, v in sd.items() if k.startswith("low_res.")}
    assert_same_tree(JW.convert_enet(enet_sd, lnet_sd), tree)


def test_gpen_roundtrip():
    tree = random_variables(FullGenerator(**GPEN_KW), (1, 64, 64, 3), equalized=True)
    sd = numpy_sd(load(TGPEN(**GPEN_KW), TW.gpen_from_jax(tree)).state_dict())
    assert_same_tree(JW.convert_gpen_full(sd, size=64, n_mlp=2), tree)


def test_parsenet_roundtrip():
    tree = random_variables(ParseNet(**PARSE_KW), (1, 64, 64, 3))
    sd = numpy_sd(load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(tree)).state_dict())
    assert_same_tree(JW.convert_parsenet(sd, res_depth=2), tree)


def test_rrdbnet_roundtrip():
    tree = random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3))
    sd = numpy_sd(load(TRRDBNet(**RRDB_KW), TW.rrdbnet_from_jax(tree)).state_dict())
    assert_same_tree(JW.convert_rrdbnet(sd, num_block=2), tree)


def test_load_reference_folds_spectral_norm():
    """A reference LNet-style conv stored as weight_orig/u/v loads as
    weight_orig / sigma with sigma = u . (W v)."""
    conv = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))
    rng = np.random.RandomState(5)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    u, v = rng.randn(4).astype(np.float32), rng.randn(27).astype(np.float32)
    sd = {"0.weight_orig": w, "0.weight_u": u, "0.weight_v": v,
          "0.bias": np.zeros(4, np.float32)}
    TW.load_reference(conv, sd)
    sigma = float(u @ (w.reshape(4, -1) @ v))
    np.testing.assert_allclose(conv[0].weight.detach().numpy(), w / sigma, rtol=1e-5)


def test_gpen_state_dict_names_match_reference_layout():
    """Key names the reference GPEN checkpoint carries (FIR buffers included)."""
    keys = set(TGPEN(**GPEN_KW).state_dict())
    for k in ("ecd0.0.0.weight", "ecd0.0.1.bias", "ecd1.0.0.kernel", "ecd1.0.1.weight",
              "ecd1.0.2.bias", "final_linear.0.weight", "generator.style.1.weight",
              "generator.input.input", "generator.conv1.conv.modulation.weight",
              "generator.conv1.noise.weight", "generator.conv1.activate.bias",
              "generator.convs.0.conv.blur.kernel", "generator.to_rgbs.0.upsample.kernel",
              "generator.to_rgb1.bias"):
        assert k in keys, k
