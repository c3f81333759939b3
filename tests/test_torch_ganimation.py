"""The port's GANimation SplitGenerator and ``--up_face`` editor against
s2v_tpu's, f32 on the CPU, on the same random weights:

- the SplitGenerator at a slim width (ngf 16, 2 resnet blocks) on 128^2
  faces: colour mask, attention mask and features within 1e-4 of their
  scale (f32, conv summation order), as tests/test_torch_models.py;
- ``make_up_face_editor`` at the geometry s2v_tpu's editor builds (ngf 64,
  6 blocks) for each ``EXP_AUS`` row, on 384^2 faces in 0..1: within 1e-4;
  ``original`` or no generator gives no editor;
- the weight round trip through s2v_tpu's ``convert_ganimation`` and the
  geometry read back from a state_dict (``ganimation_arch``).
"""

import numpy as np
import pytest
import torch

import jax

import s2v_tpu.pipeline.restoration as JR
from s2v_torch.models.ganimation import SplitGenerator as TSplit
from s2v_torch.models.ganimation import ganimation_arch
from s2v_torch.pipeline import restoration as TR
from s2v_torch.utils import weights as TW
from s2v_tpu.models.ganimation import EXP_AUS, SplitGenerator
from s2v_tpu.utils import weights as JW
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


SLIM = dict(ngf=16, n_blocks=2)


def jax_vars(kw, seed=60):
    return random_variables(SplitGenerator(**kw), (1, 128, 128, 3), (1, 17), seed=seed)


def test_split_generator_matches_jax():
    v = jax_vars(SLIM)
    rng = np.random.RandomState(61)
    img = (rng.rand(2, 128, 128, 3).astype(np.float32) - 0.5) * 2
    aus = rng.rand(2, 17).astype(np.float32) * 0.5
    want = jax.jit(SplitGenerator(**SLIM).apply)(v, img, aus)
    port = load(TSplit(**SLIM), TW.ganimation_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(img), torch.from_numpy(aus))
    for g, w in zip(got, want):
        close(g.numpy().transpose(0, 2, 3, 1), np.asarray(w))
    assert np.asarray(want[1]).std() > 1e-3  # the attention mask varies


@pytest.fixture(scope="module")
def editor_weights():
    return jax_vars({}, seed=62)


@pytest.mark.parametrize("up_face", sorted(EXP_AUS))
def test_up_face_editor_matches_jax(editor_weights, up_face):
    v = editor_weights
    faces = np.random.RandomState(63).rand(2, 384, 384, 3).astype(np.float32)
    want = JR.make_up_face_editor({"ganimation": v}, up_face)(faces)
    port = load(TSplit(), TW.ganimation_from_jax(v))
    hook = TR.make_up_face_editor({"ganimation": port}, up_face, device="cpu")
    got = hook(to_nchw(faces)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == faces.shape
    close(got, want)
    assert np.abs(want - faces).mean() > 1e-2  # the edit changed the faces


def test_no_editor_for_original_or_without_a_generator():
    assert TR.make_up_face_editor({"ganimation": TSplit(**SLIM)}, "original",
                                  device="cpu") is None
    assert TR.make_up_face_editor({}, "angry", device="cpu") is None


@pytest.mark.parametrize("kw", [SLIM, {}], ids=["slim", "default"])
def test_ganimation_roundtrip_and_geometry(kw):
    v = jax_vars(kw)
    sd = TW.ganimation_from_jax(v)
    assert_same_tree(JW.convert_ganimation(numpy_sd(sd), n_blocks=kw.get("n_blocks", 6)), v)
    module = ganimation_arch(sd)
    assert set(sd) == set(module.state_dict())
    TW.load_reference(module, sd)
    assert len(module.model) == 9 + kw.get("n_blocks", 6) + 6
