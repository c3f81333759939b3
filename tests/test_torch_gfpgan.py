"""The port's GFPGANv1Clean against s2v_tpu's on the same weights and input,
f32 on the CPU: the slim geometry of tests/slim_zoo.py at out_size 64, the
geometries of tests/test_gfpgan.py (out_size 64 at narrow 1, out_size 128 at
narrow 0.5, whose fine scales take s2v_tpu's fused condition branches), each
with ``sft_half`` on and off, and one with the style MLP on the path
(``input_is_latent=False``, one latent). Tolerance: 1e-4 of the output's
scale where it exceeds 1 (f32, conv summation order), as
tests/test_torch_models.py.

The converter's round trip through s2v_tpu's ``convert_gfpgan_clean``, and
a strict ``load_reference`` of a state_dict that carries the reference's
``toRGB.*`` heads and ``noises.*`` buffers (loaded, never run).
"""

import numpy as np
import pytest
import torch

import jax

from s2v_torch.models.gfpgan import GFPGANv1Clean as TGFPGAN
from s2v_torch.utils import weights as TW
from s2v_tpu.models.gfpgan import GFPGANv1Clean
from s2v_tpu.utils import weights as JW
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables

WIDE = dict(num_style_feat=128, channel_multiplier=2, narrow=1, num_mlp=4)
MERGED = dict(num_style_feat=128, channel_multiplier=2, narrow=0.5, num_mlp=4)
GEOMETRIES = {"slim64": (64, SLIM_GFPGAN_KW), "wide64": (64, WIDE), "merged128": (128, MERGED)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def jax_vars(size, kw, seed=20):
    """Random variables of s2v_tpu's model. With ``input_is_latent`` (the
    default) it never creates the style MLP, which a converted checkpoint
    carries (``convert_gfpgan_clean`` reads it): random layers are added,
    as the reference's state_dict always has them."""
    v = random_variables(GFPGANv1Clean(out_size=size, **kw), (1, size, size, 3), seed=seed)
    dec, nsf = v["params"]["stylegan_decoder"], kw["num_style_feat"]
    rng = np.random.RandomState(seed + 1)
    for i in range(kw.get("num_mlp", 8)):
        dec.setdefault(f"style_mlp{i}", {
            "weight": (rng.randn(nsf, nsf) / np.sqrt(nsf)).astype(np.float32),
            "bias": (0.1 * rng.randn(nsf)).astype(np.float32)})
    return v


def run_both(size, kw, seed=20):
    v = jax_vars(size, kw, seed)
    x = (np.random.RandomState(seed).rand(2, size, size, 3).astype(np.float32) - 0.5) * 2
    want = jax.jit(lambda v, x: GFPGANv1Clean(out_size=size, **kw).apply(v, x))(v, x)
    port = load(TGFPGAN(out_size=size, **kw), TW.gfpgan_clean_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(x))
    return got.numpy().transpose(0, 2, 3, 1), np.asarray(want), v, port


@pytest.mark.parametrize("sft_half", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_gfpgan_clean_matches_jax(geometry, sft_half):
    size, kw = GEOMETRIES[geometry]
    got, want, _, _ = run_both(size, dict(kw, sft_half=sft_half))
    assert got.shape == (2, size, size, 3) and want.std() > 0.1
    close(got, want)


def test_gfpgan_clean_with_the_style_mlp_matches_jax():
    got, want, _, _ = run_both(64, dict(SLIM_GFPGAN_KW, input_is_latent=False,
                                        different_w=False, num_mlp=2))
    close(got, want)


@pytest.mark.parametrize("geometry", ["slim64", "merged128"])
def test_gfpgan_clean_roundtrip(geometry):
    size, kw = GEOMETRIES[geometry]
    v = jax_vars(size, kw)
    sd = TW.gfpgan_clean_from_jax(v)
    back = JW.convert_gfpgan_clean(numpy_sd(sd), out_size=size, num_mlp=kw.get("num_mlp", 8))
    assert_same_tree(back, v)


def test_load_reference_takes_a_gfpgan_checkpoint_with_its_unused_parts():
    """A GFPGANv1.4-style ``params_ema``: the reference's key names with the
    U-Net's toRGB heads and the decoder's stored noises, here random. It
    loads strictly, and those parts change nothing."""
    size, kw = GEOMETRIES["slim64"]
    _, want, v, port = run_both(size, kw)
    sd = TW.gfpgan_clean_from_jax(v)
    unused = [k for k in sd if k.startswith(("toRGB.", "stylegan_decoder.noises."))]
    assert len(unused) == 2 * 4 + 9  # 4 heads (weight, bias), 9 noise maps
    g = torch.Generator().manual_seed(0)
    ckpt = {k: torch.randn(t.shape, generator=g) if k in unused else t for k, t in sd.items()}
    assert set(ckpt) == set(port.state_dict())
    model = TW.load_reference(TGFPGAN(out_size=size, **kw), ckpt).eval()
    assert torch.equal(model.toRGB[0].weight, ckpt["toRGB.0.weight"])
    x = (np.random.RandomState(20).rand(2, size, size, 3).astype(np.float32) - 0.5) * 2
    with torch.no_grad():
        got = model(to_nchw(x)).numpy().transpose(0, 2, 3, 1)
    close(got, want)
