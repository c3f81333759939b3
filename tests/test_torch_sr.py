"""The port's super-resolving GPEN (``FullGeneratorSR``) and tiled forward
(``tile_process``) against the JAX package's on the CPU, f32.

- ``FullGeneratorSR`` at in_size 32, out_size 64 (style 64, n_mlp 2,
  channel_multiplier 1, narrow 0.5, the geometry of tests/test_gpen.py's
  reference test), random JAX variables through ``gpen_from_jax`` (strict),
  ``deterministic=True`` (the upper level takes zeros for encoder features):
  within 1e-4 of the output's largest magnitude (measured 7.2e-7). The
  port's state_dict through s2v_tpu's ``convert_gpen_full(..., in_size=32)``
  gives back the flax tree. With ``deterministic=False`` the upper level draws its noise
  from the caller's generator: two calls with equal generators are equal,
  and differ from the zero-noise output; without a generator it raises.
- ``full_generator_sr_arch`` reads the geometry back from a state_dict,
  and ``kernel_sites`` counts the K1 and K3 calls of one forward (the
  smoke holds the card's launches to it).
- ``tile_process`` over a slim RRDBNet x2 on a 70x50 image, tile 32, pad
  4 (windows 40x40: the clamps at the bottom and right edges and the
  ragged last tiles are hit), against s2v_tpu's within 1e-5 of scale; with
  one tile over the whole frame it equals the untiled forward exactly.
"""

import numpy as np
import pytest
import torch

import jax

from s2v_torch.models import gpen as TG
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.models.rrdbnet import tile_process
from s2v_torch.train.gan import kernel_sites
from s2v_torch.utils import weights as TW
from s2v_tpu.models.gpen import FullGeneratorSR
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.models.rrdbnet import tile_process as jax_tile_process
from s2v_tpu.utils import weights as JW
from test_torch_models import RRDB_KW, assert_same_tree, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables

SR_KW = dict(in_size=32, out_size=64, style_dim=64, n_mlp=2, channel_multiplier=1,
             narrow=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def sr():
    v = random_variables(FullGeneratorSR(**SR_KW), (1, 32, 32, 3), seed=3, equalized=True)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(FullGeneratorSR(**SR_KW).apply)(v, x))
    return v, x, want


def test_full_generator_sr_matches_jax(sr):
    v, x, want = sr
    port = load(TG.FullGeneratorSR(**SR_KW), TW.gpen_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_full_generator_sr_roundtrip(sr):
    v = sr[0]
    sd = numpy_sd(load(TG.FullGeneratorSR(**SR_KW), TW.gpen_from_jax(v)).state_dict())
    assert_same_tree(JW.convert_gpen_full(sd, size=64, n_mlp=2, in_size=32), v)


def test_full_generator_sr_noise_comes_from_the_callers_generator(sr):
    v, x = sr[0], to_nchw(sr[1])
    port = load(TG.FullGeneratorSR(**SR_KW), TW.gpen_from_jax(v))
    with torch.no_grad():
        zero = port(x)
        a = port(x, deterministic=False, generator=torch.Generator().manual_seed(7))
        b = port(x, deterministic=False, generator=torch.Generator().manual_seed(7))
        with pytest.raises(ValueError, match="Generator"):
            port(x, deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - zero).abs().max() > 1e-3


@pytest.mark.parametrize("kw", [SR_KW, dict(in_size=64, out_size=256, style_dim=64, n_mlp=2,
                                            channel_multiplier=0.5, narrow=0.25)])
def test_full_generator_sr_arch_reads_the_geometry(kw):
    sd = TG.FullGeneratorSR(**kw).state_dict()
    model = TG.full_generator_sr_arch(sd, kw["in_size"], kw["out_size"])
    model.load_state_dict(sd)  # strict
    assert (model.log_size, model.free_levels) == (
        int(np.log2(kw["in_size"])), int(np.log2(kw["out_size"] / kw["in_size"])))


def test_kernel_sites_count_a_forwards_kernel_calls(sr, monkeypatch):
    calls = {"fused_act": 0, "upfirdn2d": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(TG, "fused_bias_leaky_relu",
                        counted("fused_act", TG.fused_bias_leaky_relu))
    monkeypatch.setattr(TG, "upfirdn2d", counted("upfirdn2d", TG.upfirdn2d))
    model = TG.FullGeneratorSR(**SR_KW).eval()
    with torch.no_grad():
        model(to_nchw(sr[1]))
    assert (calls["fused_act"], calls["upfirdn2d"]) == kernel_sites(model) == (16, 11)


@pytest.fixture(scope="module")
def rrdb():
    v = random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3), seed=5)
    img = np.random.RandomState(6).rand(1, 70, 50, 3).astype(np.float32)
    return v, img, load(TRRDBNet(**RRDB_KW), TW.rrdbnet_from_jax(v))


def test_tile_process_matches_jax(rrdb):
    v, img, port = rrdb
    apply = jax.jit(RRDBNet(**RRDB_KW).apply)
    want = jax_tile_process(lambda t: apply(v, t), img, 2, tile_size=32, tile_pad=4)
    with torch.no_grad():
        got = tile_process(port, to_nchw(img), 2, tile_size=32, tile_pad=4)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 140, 100, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_tile_process_with_one_tile_is_the_untiled_forward(rrdb):
    _, img, port = rrdb
    x = to_nchw(img)
    with torch.no_grad():
        tiled = tile_process(port, x, 2, tile_size=70, tile_pad=4)
        whole = port(x)
    torch.testing.assert_close(tiled, whole, rtol=0, atol=0)
