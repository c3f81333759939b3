"""The port's GFPGANv1 (the original arch, a GFPGANv1.pth) against s2v_tpu's
on the same weights and input, f32 on the CPU, at out_size 64 with
tests/slim_zoo.py's widths:

- with GFPGANer's wiring (``input_is_latent``, ``different_w``) and
  ``sft_half`` on and off, so that a swapped half cannot pass unseen; and
  with the class defaults (one latent through the 8-layer style MLP, K1
  sites of its own). Tolerance: 1e-4 of the output's scale where it
  exceeds 1 (f32, conv summation order), as tests/test_torch_models.py.
- ``gfpgan_arch(arch="original")`` reads the geometry back from a
  state_dict, slim and at production widths (on the meta device).
- The round trip: the port's state_dict through s2v_tpu's
  ``convert_gfpgan_v1`` gives back the flax tree, and every key the port
  module has, basicsr's FIR and noise buffers included, is in that
  state_dict (a strict load). A file without the constant FIR keys (basicsr
  keeps them as plain attributes) loads too and gives the same module; a
  FIR of another value, or a missing noise buffer, is refused.
- The launch sites: one forward calls the K1 and K3 wrappers exactly
  ``forward_launches`` times (45 and 28 for GFPGANv1(512)); on the CPU the
  wrappers run their plain versions, so the calls are counted here.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from s2v_torch.models import gfpgan as t_gfpgan
from s2v_torch.models import gpen as t_gpen
from s2v_torch.models.gfpgan import GFPGANv1 as TGFPGANv1
from s2v_torch.models.gfpgan import forward_launches, gfpgan_arch
from s2v_torch.utils import weights as TW
from s2v_tpu.models.gfpgan import GFPGANv1
from s2v_tpu.utils import weights as JW
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


SIZE = 64
GFPGANER = dict(input_is_latent=True, different_w=True)  # gfpgan/utils.py:63-74


def jax_v1_vars(kw, seed=30, size=SIZE):
    """Random variables of s2v_tpu's GFPGANv1. Under ``input_is_latent`` it
    never creates the style MLP, which a GFPGANv1.pth carries and
    ``convert_gfpgan_v1`` reads: random layers are added then."""
    v = random_variables(GFPGANv1(out_size=size, **kw), (1, size, size, 3), seed=seed,
                         equalized=True)
    dec, nsf = v["params"]["stylegan_decoder"], kw["num_style_feat"]
    rng = np.random.RandomState(seed + 1)
    for i in range(kw.get("num_mlp", 8)):
        dec.setdefault(f"style{i}", {
            "weight": (rng.randn(nsf, nsf) * 100.0).astype(np.float32),  # lr_mul 0.01
            "bias": (0.1 * rng.randn(nsf)).astype(np.float32)})
    return v


WIRINGS = {"gfpganer_sft_half": dict(GFPGANER, sft_half=True),
           "gfpganer_full_sft": dict(GFPGANER, sft_half=False),
           "class_defaults": dict(num_mlp=2)}


@functools.lru_cache(maxsize=None)
def run_wiring(name):
    """``run_both`` once per wiring in this process (the JAX compile is the
    cost)."""
    return run_both(dict(SLIM_GFPGAN_KW, **WIRINGS[name]))


def run_both(kw, seed=30):
    v = jax_v1_vars(kw, seed)
    x = (np.random.RandomState(seed).rand(2, SIZE, SIZE, 3).astype(np.float32) - 0.5) * 2
    want, want_rgbs = jax.jit(lambda v, x: GFPGANv1(out_size=SIZE, **kw).apply(v, x))(v, x)
    port = load(TGFPGANv1(out_size=SIZE, **kw), TW.gfpgan_v1_from_jax(v))
    with torch.no_grad():
        got, got_rgbs = port(to_nchw(x))
    return got, want, got_rgbs, want_rgbs, v, port


@pytest.mark.parametrize("wiring", list(WIRINGS))
def test_gfpgan_v1_matches_jax(wiring):
    got, want, got_rgbs, want_rgbs, _, _ = run_wiring(wiring)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == (2, SIZE, SIZE, 3) and np.asarray(want).std() > 0.1
    close(got, np.asarray(want))
    assert len(got_rgbs) == len(want_rgbs) == 4
    for g, w in zip(got_rgbs, want_rgbs):
        close(g.numpy().transpose(0, 2, 3, 1), np.asarray(w))


def test_sft_half_selects_the_second_half():
    """The two wirings give different images on the same input (a no-op
    SFT would pass the parity tests above only if both were wrong alike)."""
    half, full = run_wiring("gfpganer_sft_half")[0], run_wiring("gfpganer_full_sft")[0]
    assert (half - full).abs().max().item() > 1e-2


@pytest.mark.parametrize("wiring", [dict(GFPGANER, sft_half=True), dict(num_mlp=2)])
def test_gfpgan_v1_roundtrip(wiring):
    kw = dict(SLIM_GFPGAN_KW, **wiring)
    v = jax_v1_vars(kw)
    sd = TW.gfpgan_v1_from_jax(v)
    back = JW.convert_gfpgan_v1(numpy_sd(sd), out_size=SIZE, num_mlp=kw.get("num_mlp", 8))
    assert_same_tree(back, v)
    module = TGFPGANv1(out_size=SIZE, **kw)
    assert set(sd) == set(module.state_dict())
    buffers = [k for k in sd if k.endswith(".kernel") or ".noises." in k]
    assert len(buffers) == 4 * 2 + 4 + 4 + 9  # down blurs, smooths, to_rgbs, noises
    TW.load_reference(module, sd)


@pytest.mark.parametrize("layout", ["without_fir_keys", "with_fir_keys",
                                    "wrong_fir_value", "without_noise"])
def test_gfpgan_v1_loads_either_fir_layout(layout):
    kw = dict(SLIM_GFPGAN_KW, **GFPGANER, sft_half=True)
    torch.manual_seed(3)
    want = TGFPGANv1(out_size=SIZE, **kw)
    sd = want.state_dict()
    firs = [k for k in sd if k.endswith(".kernel")]
    assert len(firs) == 4 * 2 + 4 + 4  # down blurs, smooths, to_rgbs
    if layout == "without_fir_keys":
        sd = {k: v for k, v in sd.items() if k not in firs}
    elif layout == "wrong_fir_value":
        sd = dict(sd, **{firs[0]: sd[firs[0]] * 2})
    elif layout == "without_noise":
        sd = {k: v for k, v in sd.items() if not k.endswith(".noises.noise0")}
    got = TGFPGANv1(out_size=SIZE, **kw)
    if layout in ("wrong_fir_value", "without_noise"):
        with pytest.raises(RuntimeError, match="kernel|noise0"):
            TW.load_reference(got, sd)
        return
    TW.load_reference(got, sd)
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 want.state_dict().values()))


@pytest.mark.parametrize("widths", ["slim", "production"])
@pytest.mark.parametrize("sft_half", [True, False])
def test_gfpgan_arch_reads_the_original_geometry(widths, sft_half):
    """The geometry from a state_dict; the wiring flags from the caller."""
    size, kw = (SIZE, dict(SLIM_GFPGAN_KW, num_mlp=3)) if widths == "slim" else (512, {})
    flags = dict(GFPGANER, sft_half=sft_half)
    with torch.device("meta"):
        want = TGFPGANv1(out_size=size, **kw, **flags)
        got = gfpgan_arch(want.state_dict(), out_size=size, arch="original", **flags)
    assert isinstance(got, TGFPGANv1) and got.input_is_latent and got.different_w
    assert ({k: v.shape for k, v in got.state_dict().items()}
            == {k: v.shape for k, v in want.state_dict().items()})


def test_forward_launches_at_512():
    with torch.device("meta"):
        model = TGFPGANv1(out_size=512, **GFPGANER, sft_half=True)
        clean = t_gfpgan.GFPGANv1Clean()
    assert forward_launches(model) == {"fused_act": 45, "fused_act_bwd": 0, "upfirdn2d": 28}
    assert forward_launches(clean) == {"fused_act": 0, "fused_act_bwd": 0, "upfirdn2d": 0}


@pytest.mark.parametrize("wiring", [dict(GFPGANER, sft_half=True), dict(num_mlp=2)])
def test_one_forward_calls_the_kernels_at_every_site(monkeypatch, wiring):
    calls = {"fused_act": 0, "upfirdn2d": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(t_gpen, "fused_bias_leaky_relu",
                        counted("fused_act", t_gpen.fused_bias_leaky_relu))
    monkeypatch.setattr(t_gpen, "upfirdn2d", counted("upfirdn2d", t_gpen.upfirdn2d))
    model = TGFPGANv1(out_size=SIZE, **SLIM_GFPGAN_KW, **wiring).eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, SIZE, SIZE))
    want = forward_launches(model)
    assert calls == {k: want[k] for k in calls}
    assert want["fused_act"] == 1 + 1 + 4 * 2 + 4 * 2 + 1 + 8 + (0 if wiring.get(
        "input_is_latent") else 2)
