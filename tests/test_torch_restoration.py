"""The port's mouth tail against s2v_tpu's, f32 on the CPU, on the same slim
weights (GFPGANv1Clean at out_size 64 with tests/slim_zoo.py's widths,
RetinaFace cfg_mnet, ParseNet, GPEN, RealESRNet and ENet at the widths of
tests/test_torch_pipeline.py) and inputs:

- ``pyr_down``, ``pyr_up`` and ``laplacian_pyramid_blend`` at 512^2 with 10
  and 6 levels, at 64^2 down to a 1x1 base, non-square down to 1x2, and
  with a 3x4 base; tolerance 1e-3 on 0..255;
- ``GFPGANRestorer.enhance_batch`` detecting, with landmarks supplied (no
  detector), and with one frame under the threshold, which keeps its input;
- the mouth hook (``make_mouth_restorer``) detecting and with
  ``landmarks5``;
- ``FaceEnhancer``'s non-SR Laplacian composites, ``possion`` (boxes) and
  ``possion_nobbox``.

``synthesize`` with the mouth tail is in tests/test_torch_mouth_synthesize.py
(the two files take about the same time).

s2v_tpu's ``make_mouth_restorer`` builds its restorer in bf16; the tests
hand it one built in f32 (as tests/test_restoration_tail.py hands it one).

Random weights would make a tail that does nothing: RetinaFace would find
no face (its level-2 face logit is raised, as in tests/test_torch_step5.py,
and the tests assert which frames are valid and that the argmax margins
hold), and ParseNet's mouth classes (10-12) would never win, so the blend
would return its input. ParseNet's class-11 logit is raised by 100, twice
the spread of these random weights' logits (class 11 is 255 in both the
mouth and the face colormap); the tests assert the mouth
mask covers the face boxes with every top-2 logit margin over 1e-3, and that
the tail changed the boxes by a mean of 5 gray levels or more.

Tolerance on the uint8 output as tests/test_torch_pipeline.py: within one
gray level, at most 0.1% of subpixels off by more than 1, a mean difference
under 0.01.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2v_tpu.pipeline.restoration as JR
from s2v_torch.models import retinaface as t_rf
from s2v_torch.models.gfpgan import GFPGANv1Clean as TGFPGAN
from s2v_torch.models.parsenet import MOUTH_COLORMAP, parse_mask
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.ops.warp import crop_resize_boxes
from s2v_torch.pipeline import enhance as t_enh
from s2v_torch.pipeline import restoration as TR
from s2v_torch.pipeline import utils as TU
from s2v_torch.utils import weights as TW
from s2v_tpu.models import retinaface as j_rf
from s2v_tpu.models.fan import lm68_to_lm5
from s2v_tpu.models.parsenet import ParseNet
from s2v_tpu.pipeline import utils as JU
from s2v_tpu.pipeline.enhance import FaceEnhancer
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_gfpgan import jax_vars
from test_torch_models import load
from test_torch_pipeline import IN_SIZE, PARSE, PARSE_KW, assert_close_frames
from test_torch_step5 import (FACE_BIAS, THRESHOLD_LOGIT, assert_detects, face_logits,
                              port_models, stab_frames, with_face_bias)
from test_torch_step5 import weights as step5_weights  # noqa: F401 (a fixture)
from torch_parity import fixed_landmarks, one_torch_thread, random_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


N, H, W = 4, 96, 112
SIZE = 64  # GFPGAN's out_size and the restorer's template size
MOUTH_CLASS = 11
MOUTH_BIAS = 100.0  # these random weights' logits span about +-50


def unsaturated(gfpgan, scale=0.04):
    """The GFPGAN tree with its ToRGB layers scaled by ``scale``. Random
    weights put 90% of the output outside [-1, 1]: the restored face is then
    mostly exact 0s and 255s, and a paste of those lands on integers, where
    the last f32 bit decides the uint8 truncation (measured: 7% of subpixels
    one gray level apart, none further). Scaled, the output on the tests'
    face crops stays within 0.8 of 0."""
    out = copy.deepcopy(gfpgan)
    for name, layer in out["params"]["stylegan_decoder"].items():
        if name.startswith("to_rgb"):
            layer["modulated_conv"]["weight"] = layer["modulated_conv"]["weight"] * scale
            layer["bias"] = layer["bias"] * scale
    return out


@pytest.fixture(scope="module")
def tail_weights():
    parse = random_variables(ParseNet(**PARSE_KW), (1, PARSE, PARSE, 3), seed=82)
    parse["params"]["out_mask_conv"]["conv2d"]["bias"][MOUTH_CLASS] += MOUTH_BIAS
    return dict(retinaface=random_variables(j_rf.retinaface_mnet(), (1, 128, 128, 3), seed=80),
                gfpgan=unsaturated(jax_vars(SIZE, SLIM_GFPGAN_KW, seed=81)), parsenet=parse)


def level2_face(retina, bias=FACE_BIAS):
    """``with_face_bias`` (level 2's class head x10, its face logits raised
    by ``bias``), with the face logits of levels 0 and 1 lowered by 20:
    random cfg_mnet weights score some small anchors of these 96x112 frames
    near 0.98, and level 2 alone then decides every detection, as the
    margins the tests assert assume."""
    out = with_face_bias(retina, bias)
    for level in (0, 1):
        out["params"][f"ClassHead{level}"]["bias"][[1, 3]] -= 20.0
    return out


def tail_frames(seed=83):
    """Noisy gradients at the slice's frame size and, as frame 2, a flat
    gray frame, whose best face logit lies well under the others'."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255.0 / W, yy * 255.0 / H, (xx + yy) * 127.0 / (H + W)], -1)
    frames = np.clip(base[None] + rng.randn(N, H, W, 3) * 40, 0, 255).astype(np.uint8)
    frames[2] = 128
    return frames


def tail_boxes():
    boxes = np.tile(np.asarray([26, 18, 86, 80], np.float32), (N, 1))
    boxes[1] = [30.5, 24.25, 78.75, 74.5]
    return boxes


def port_tail_models(v, retina=None):
    models = dict(gfpgan=load(TGFPGAN(out_size=SIZE, **SLIM_GFPGAN_KW),
                              TW.gfpgan_clean_from_jax(v["gfpgan"])),
                  parsenet=load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(v["parsenet"])))
    if retina is not None:
        models["retinaface"] = load(t_rf.retinaface_mnet(), TW.retinaface_from_jax(retina))
    return models


def jax_restorer(v, retina, threshold=0.9):
    return JR.GFPGANRestorer({"retinaface": retina, "gfpgan": v["gfpgan"]}, threshold=threshold,
                             chunk=N, size=SIZE, dtype="float32")


def port_restorer(v, retina):
    models = port_tail_models(v, retina)
    del models["parsenet"]
    return TR.GFPGANRestorer(models, chunk=3, dtype="float32", device="cpu")


def jax_mouth(v, retina, monkeypatch):
    """s2v_tpu's hook as its cli builds it, with its restorer in f32."""
    restorer = jax_restorer(v, retina)
    with monkeypatch.context() as m:
        m.setattr(JR, "GFPGANRestorer", lambda *a, **k: restorer)
        return JR.make_mouth_restorer({"retinaface": retina, "gfpgan": v["gfpgan"],
                                       "parsenet": v["parsenet"]}, chunk=N, parse_size=PARSE,
                                      size=SIZE)


def port_mouth(v, retina):
    return TR.make_mouth_restorer(port_tail_models(v, retina), chunk=3, parse_size=PARSE,
                                  dtype="float32", device="cpu")


def changed_in_boxes(out, frames, boxes):
    """Mean absolute change over the boxes' pixels, in gray levels."""
    d = []
    for o, f, (x1, y1, x2, y2) in zip(out, frames, np.asarray(boxes).astype(int)):
        d.append(np.abs(o[y1:y2, x1:x2].astype(np.int32) - f[y1:y2, x1:x2]).mean())
    return float(np.mean(d))


@torch.no_grad()
def assert_mouth_mask_covers(v, restored, boxes):
    """The mouth mask ParseNet gives the restored face boxes (the port's
    modules) covers them, and no argmax is near a tie."""
    parse = load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(v["parsenet"]))
    x = torch.as_tensor(np.asarray(restored)).permute(0, 3, 1, 2).float()
    crop = crop_resize_boxes(x, torch.as_tensor(np.asarray(boxes, np.float32)), (PARSE, PARSE))
    logits, _ = parse(crop / 255.0 * 2.0 - 1.0)
    top = logits.topk(2, dim=1).values
    assert (top[:, 0] - top[:, 1]).min().item() > 1e-3
    assert (parse_mask(logits, MOUTH_COLORMAP) > 0).float().mean().item() > 0.99


@pytest.mark.parametrize("h,w,levels", [(512, 512, 10), (512, 512, 6), (64, 64, 7),
                                        (256, 512, 9), (96, 128, 6)])
def test_pyramid_ops_and_blend_match_jax(h, w, levels):
    """Down to 1x1 at 512^2 (10 levels) and at 64^2 (7), where the 5-tap
    filter reflects a 1- or 2-pixel axis more than once; non-square down to
    1x2; odd sizes (a 3x4 base). Sizes halve evenly to the base, as the
    reference's cv2.subtract needs."""
    rng = np.random.RandomState(h + w + levels)
    a, b = [(rng.rand(2, h, w, 3) * 255).astype(np.float32) for _ in range(2)]
    m = rng.rand(2, h, w, 1).astype(np.float32)

    def nchw(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))

    def nhwc(x):
        return x.numpy().transpose(0, 2, 3, 1)

    for got, want in ((TU.pyr_down(nchw(a)), JU.pyr_down(jnp.asarray(a))),
                      (TU.pyr_up(nchw(a)), JU.pyr_up(jnp.asarray(a))),
                      (TU.laplacian_pyramid_blend(nchw(a), nchw(b), nchw(m), levels),
                       jax.jit(JU.laplacian_pyramid_blend, static_argnums=3)(a, b, m, levels))):
        assert nhwc(got).shape == np.asarray(want).shape
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("up", [False, True])
def test_reflect_padding_repeats_as_numpy_does(n, up):
    """The pyramids' matrices on axes no longer than the pad: numpy's (and
    jnp.pad's) repeated REFLECT_101, which F.pad refuses, against the 5-tap
    filter on an np.pad-ded axis (pyrDown keeps the even outputs; pyrUp
    filters the zero-stuffed axis with gain 2 per axis)."""
    x = np.random.RandomState(n).rand(n)
    if up:
        z = np.zeros(2 * n)
        z[0::2] = x
        x_in, gain, step = z, 2.0, 1
    else:
        x_in, gain, step = x, 1.0, 2
    p = np.pad(x_in, 2, mode="reflect")
    taps = np.asarray(TU._PYR_TAPS) * gain
    want = np.asarray([p[i:i + 5] @ taps for i in range(len(x_in))])[::step]
    got = TU._pyr_matrix(n, up) @ x.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_restorer_detecting_matches_jax(tail_weights):
    v = tail_weights
    retina = level2_face(v["retinaface"])
    frames = tail_frames()
    assert_detects(retina, frames, [True] * N)
    want = jax_restorer(v, retina).enhance_batch(frames)
    tr = port_restorer(v, retina)
    got = tr.enhance_batch(frames)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert_close_frames(got.numpy(), want)
    assert changed_in_boxes(want, frames, tail_boxes()) > 5.0
    one = tr.enhance(frames[0]).numpy()
    assert np.abs(one.astype(np.int32) - got[0].numpy()).max() <= 1


def test_restorer_with_landmarks_supplied_matches_jax(tail_weights):
    """``landmarks5`` replace the detector: the port's restorer has none."""
    v = tail_weights
    frames = tail_frames()
    lm5 = lm68_to_lm5(fixed_landmarks(N, H, W, seed=85)).astype(np.float32)
    want = np.asarray(jax_restorer(v, v["retinaface"])._restore_full_lm(
        v["gfpgan"], jnp.asarray(frames), jnp.asarray(lm5)))
    tr = port_restorer(v, None)
    assert "retinaface" not in tr.models
    got = tr.enhance_batch(frames, landmarks5=lm5).numpy()
    assert_close_frames(got, want)
    assert changed_in_boxes(want, frames, tail_boxes()) > 5.0
    with pytest.raises(ValueError, match="retinaface"):
        tr.enhance_batch(frames)


def test_restorer_keeps_a_frame_under_the_threshold(tail_weights):
    """The face bias set between the two lowest best logits: that frame
    falls under 0.9 and comes back as it went in, on both sides."""
    v = tail_weights
    frames = tail_frames()
    best, _ = face_logits(level2_face(v["retinaface"], 0.0), frames)
    low, second = np.sort(best)[:2]
    retina = level2_face(v["retinaface"], THRESHOLD_LOGIT - (low + second) / 2)
    valid = best > (low + second) / 2
    assert_detects(retina, frames, valid)
    want = jax_restorer(v, retina).enhance_batch(frames)
    got = port_restorer(v, retina).enhance_batch(frames).numpy()
    assert_close_frames(got, want)
    bad = int(np.argmin(best))
    np.testing.assert_array_equal(got[bad], frames[bad])
    np.testing.assert_array_equal(want[bad], frames[bad])
    assert changed_in_boxes(want[valid], frames[valid], tail_boxes()[valid]) > 5.0


@pytest.mark.parametrize("with_landmarks", [False, True])
def test_mouth_hook_matches_jax(tail_weights, monkeypatch, with_landmarks):
    v = tail_weights
    retina = level2_face(v["retinaface"])
    frames, boxes = tail_frames(), tail_boxes()
    frames[2] = tail_frames(seed=84)[0]  # every frame valid
    assert_detects(retina, frames, [True] * N)
    kw = {}
    if with_landmarks:  # the random detector would find nothing
        retina = v["retinaface"]
        kw["landmarks5"] = lm68_to_lm5(fixed_landmarks(N, H, W, seed=85)).astype(np.float32)
    want = jax_mouth(v, retina, monkeypatch)(frames, boxes, **kw)
    hook = port_mouth(v, retina)
    got = hook(frames, boxes, **kw)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    assert_close_frames(got.numpy(), want)
    restored = hook.restorer.enhance_batch(frames, **kw)
    assert_mouth_mask_covers(v, restored, boxes)
    assert changed_in_boxes(want, frames, boxes) > 5.0


def test_make_mouth_restorer_needs_all_three_models(tail_weights):
    models = port_tail_models(tail_weights, tail_weights["retinaface"])
    for name in models:
        assert TR.make_mouth_restorer({k: m for k, m in models.items() if k != name},
                                      device="cpu") is None
    assert TR.make_mouth_restorer(dict(models, gfpgan=None), device="cpu") is None


@pytest.mark.parametrize("with_boxes", [True, False])
def test_enhancer_laplacian_composites_match_jax(step5_weights, with_boxes):  # noqa: F811
    """``possion_blending`` without SR: the 6-level blend over the sharp mask
    restricted to the boxes, or over the full mask."""
    v = step5_weights
    retina = level2_face(v["retinaface"])
    frames = stab_frames()
    frames[2] = stab_frames(seed=77)[0]
    assert_detects(retina, frames, [True] * N)
    bb = np.asarray([[40, 230, 30, 220], [60.7, 200.2, 50.5, 180.9], [0, 256, 0, 256],
                     [100, 180, 20, 240]], np.float32) if with_boxes else None
    jenh = FaceEnhancer({"retinaface": retina, "facegan": v["facegan"],
                         "parsenet": v["parsenet"]}, in_size=IN_SIZE, dtype="float32",
                        parse_size=PARSE)
    want = jenh.process_batch(frames, face_enhance=True, possion_blending=True, bboxes=bb)
    tenh = t_enh.FaceEnhancer(port_models(v, retina, ("facegan", "parsenet")), in_size=IN_SIZE,
                              dtype="float32", parse_size=PARSE, device="cpu")
    got = tenh.process_batch(frames, face_enhance=True, possion_blending=True, bboxes=bb)
    assert_close_frames(got.numpy(), want)
    assert np.abs(want.astype(np.int32) - frames).mean() > 1.0


def test_restorer_entry_points_refuse_without_a_card(tail_weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    models = port_tail_models(tail_weights, tail_weights["retinaface"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.GFPGANRestorer({"gfpgan": models["gfpgan"]})
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.make_mouth_restorer(models)
