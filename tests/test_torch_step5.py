"""Step 5 and the RetinaFace final path of the port against s2v_tpu, f32 on
the CPU, on the same slim weights (GPEN, ParseNet, RRDBNet and ENet at the
widths of tests/test_torch_pipeline.py, RetinaFace cfg_mnet) and inputs:

- the Step-5 enhancer (``FaceEnhancer(in_size=64)``, ``face_enhance=False``,
  the default composite) detecting with RetinaFace, and with ``landmarks5``
  supplied;
- the final hook with SR and no landmarks, detecting on the bilinear-2x
  frame, against the JAX package's cli-style hook;
- a clip with one frame whose face scores under the threshold: both sides
  return that frame unchanged;
- ``synthesize`` in the default configuration (``reuse_detections=False``)
  on the Step-5 output, against the JAX ``synthesize`` with ``lms_stab``
  supplied.

Random RetinaFace weights score every anchor near 0.5, under the 0.9
threshold, and the composite would silently return the input. So the face
logit of the level-2 anchors (``ClassHead.2`` channels 1 and 3: the class
pairs sit per anchor) is raised, that head's weights are scaled by 10 so the
anchors' logits spread apart, and every test asserts which frames are
valid. The argmax is over anchors, so each test also asserts that the top-2
margin of the face logit exceeds 1e-3 in every frame, and every frame's
best logit lies 1e-3 or more from the threshold's: a hundred times the two
packages' measured difference in the logits (the scores differ by 9e-7).

Tolerance on the uint8 output, as tests/test_torch_pipeline.py: within one
gray level, at most 0.1% of subpixels off by more than 1 (a ParseNet argmax
that flips on a near-tie) and a mean difference under 0.01.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.models import fan as t_fan
from s2v_torch.models import retinaface as t_rf
from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.pipeline import enhance as t_enh
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models import ENet
from s2v_tpu.models import retinaface as j_rf
from s2v_tpu.models.fan import lm68_to_lm5
from s2v_tpu.models.gpen import FullGenerator
from s2v_tpu.models.parsenet import ParseNet
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.pipeline.enhance import FaceEnhancer
from s2v_tpu.pipeline.inference import LipSyncPipeline, PipelineModels
from s2v_tpu.utils.config import PipelineConfig, override
from test_pipeline_e2e import synthetic_landmarks
from test_torch_models import load
from test_torch_pipeline import (ENET_KW, GPEN_KW, IN_SIZE, PARSE, PARSE_KW, RRDB_KW,
                                 assert_close_frames, slice_inputs)
from torch_parity import one_torch_thread, random_variables

N = 4
THRESHOLD_LOGIT = float(np.log(9.0))  # score 0.9
FACE_BIAS = 4.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def weights():
    return dict(
        retinaface=random_variables(j_rf.retinaface_mnet(), (1, 128, 128, 3), seed=70),
        facegan=random_variables(FullGenerator(**GPEN_KW), (1, IN_SIZE, IN_SIZE, 3), seed=71,
                                 equalized=True),
        parsenet=random_variables(ParseNet(**PARSE_KW), (1, PARSE, PARSE, 3), seed=72),
        srmodel=random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3), seed=73),
        enet=random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6), (1, 96, 96, 3),
                              seed=74))


def with_face_bias(retina, bias):
    """The RetinaFace tree with level 2's class head scaled by 10 and the
    face logit of its two anchors raised by ``bias``."""
    out = copy.deepcopy(retina)
    out["params"]["ClassHead2"]["weight"] *= 10.0
    out["params"]["ClassHead2"]["bias"][[1, 3]] += bias
    return out


def port_models(v, retina, names=("parsenet",)):
    make = dict(facegan=(TGPEN(**GPEN_KW), TW.gpen_from_jax),
                parsenet=(TParseNet(**PARSE_KW), TW.parsenet_from_jax),
                srmodel=(TRRDBNet(**RRDB_KW), TW.rrdbnet_from_jax))
    models = {k: load(make[k][0], make[k][1](v[k])) for k in names}
    models["retinaface"] = load(t_rf.retinaface_mnet(), TW.retinaface_from_jax(retina))
    return models


@torch.no_grad()
def face_logits(retina, frames):
    """Per frame (RGB uint8 NHWC), from the port's detector: the best face
    logit over the level-2 anchors and its margin over the second best."""
    model = load(t_rf.retinaface_mnet(), TW.retinaface_from_jax(retina))
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
    _, conf, _ = model(x.flip(1) - torch.tensor(t_rf.RETINA_MEAN).view(1, 3, 1, 1))
    h, w = frames.shape[1:3]
    n2 = 2 * -(-h // 32) * -(-w // 32)
    top = (conf[:, -n2:, 1].log() - conf[:, -n2:, 0].log()).topk(2, dim=1).values
    return top[:, 0].numpy(), (top[:, 0] - top[:, 1]).numpy()


def assert_detects(retina, frames, valid):
    """Every frame's argmax is well separated, and exactly ``valid`` frames
    score over the threshold, by a margin."""
    best, margin = face_logits(retina, frames)
    assert margin.min() > 1e-3, margin
    assert np.all(np.abs(best - THRESHOLD_LOGIT) > 1e-3), best
    np.testing.assert_array_equal(best > THRESHOLD_LOGIT, valid)


def stab_frames(seed=75):
    """Noisy gradients and, as frame 2, a flat gray frame, whose best face
    logit lies well under the others'."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:256]
    base = np.stack([xx, yy, (xx + yy) / 2], -1).astype(np.float32)
    frames = np.clip(base[None] + rng.randn(N, 256, 256, 3) * 40, 0, 255).astype(np.uint8)
    frames[2] = 128
    return frames


def step5_both(v, retina, frames, **kw):
    """s2v_tpu's Step-5 enhancer (built as cli.py builds it, GPEN-512
    included) and the port's (no GPEN: it never runs), same weights."""
    jenh = FaceEnhancer({"retinaface": retina, "facegan": v["facegan"],
                         "parsenet": v["parsenet"]},
                        in_size=IN_SIZE, dtype="float32", parse_size=PARSE)
    want = jenh.process_batch(frames, face_enhance=False, **kw)
    tenh = t_enh.FaceEnhancer(port_models(v, retina), in_size=IN_SIZE, dtype="float32",
                              parse_size=PARSE, device="cpu")
    got = t_enh.reference_enhancer_hook(tenh)(frames, **kw)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    return want, got.numpy()


def test_step5_enhancer_detecting_with_retinaface_matches_jax(weights):
    retina = with_face_bias(weights["retinaface"], FACE_BIAS)
    frames = stab_frames()
    assert_detects(retina, frames, [True] * N)
    want, got = step5_both(weights, retina, frames)
    assert want.shape == (N, 256, 256, 3)
    assert_close_frames(got, want)
    assert np.abs(want.astype(np.int32) - frames).max() > 10  # the faces were pasted


def test_step5_enhancer_with_landmarks_supplied_matches_jax(weights):
    """``landmarks5`` replace the detector (reuse_detections); the random
    detector would find no face here, so a match shows it did not run. The
    faces go over other frames (``ori_frames``, the paste base)."""
    frames = stab_frames()
    ori = stab_frames(seed=76)
    lm5 = lm68_to_lm5(synthetic_landmarks(N, 256, 256)).astype(np.float32)
    boxes = np.tile(np.asarray([60, 50, 196, 220], np.float32), (N, 1))
    boxes[1] = [100, 100, 180, 190]  # a small face: the 3x3 smoothing filter
    want, got = step5_both(weights, weights["retinaface"], frames, ori_frames=ori,
                           landmarks5=lm5, det_boxes=boxes)
    assert_close_frames(got, want)
    assert np.abs(want.astype(np.int32) - ori).max() > 10


def test_clip_with_an_invalid_frame_keeps_it_on_both_sides(weights):
    """The face bias set between the frames' best logits: the frame that
    scores lowest falls under 0.9 and comes back as it went in."""
    frames = stab_frames()
    best, _ = face_logits(with_face_bias(weights["retinaface"], 0.0), frames)
    low, second = np.sort(best)[:2]
    retina = with_face_bias(weights["retinaface"], THRESHOLD_LOGIT - (low + second) / 2)
    valid = best > (low + second) / 2
    assert_detects(retina, frames, valid)
    want, got = step5_both(weights, retina, frames)
    assert_close_frames(got, want)
    bad = int(np.argmin(best))
    np.testing.assert_array_equal(got[bad], frames[bad])
    np.testing.assert_array_equal(want[bad], frames[bad])
    assert np.abs(want[valid].astype(np.int32) - frames[valid]).max() > 10


def jax_final(v, retina):
    """cli.py's final stage: FaceEnhancer with SR and its hook."""
    final = FaceEnhancer({"retinaface": retina, "facegan": v["facegan"],
                          "parsenet": v["parsenet"], "srmodel": v["srmodel"]},
                         in_size=IN_SIZE, use_sr=True, sr_scale=2, dtype="float32",
                         parse_size=PARSE)

    def hook(frames, boxes_xyxy, **kw):
        return final.process_batch(frames, face_enhance=True, possion_blending=True,
                                   bboxes=np.asarray(boxes_xyxy)[:, [1, 3, 0, 2]], **kw)

    return hook


def port_final(v, retina):
    final = t_enh.FaceEnhancer(port_models(v, retina, ("facegan", "parsenet", "srmodel")),
                               in_size=IN_SIZE, dtype="float32", parse_size=PARSE,
                               device="cpu")
    return t_enh.final_enhancer_hook(final)


def up2(frames):
    """The bilinear-2x frames the final stage detects on."""
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float()
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                         align_corners=False)
    return torch.clamp(up, 0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def test_final_hook_detecting_with_retinaface_matches_jax(weights):
    retina = with_face_bias(weights["retinaface"], FACE_BIAS)
    x = slice_inputs(n=N)
    assert_detects(retina, up2(x["frames"]), [True] * N)
    want = jax_final(weights, retina)(x["frames"], x["boxes"])
    got = port_final(weights, retina)(x["frames"], x["boxes"]).numpy()
    assert want.shape == (N, 2 * x["frames"].shape[1], 2 * x["frames"].shape[2], 3)
    assert_close_frames(got, want)


def test_synthesize_in_the_default_configuration_matches_jax(weights):
    """Steps 5 -> 6 without reuse_detections: the Step-5 output as the
    stabilised frames, the final hook detecting its own faces."""
    retina = with_face_bias(weights["retinaface"], FACE_BIAS)
    x = slice_inputs(n=N)
    stab, _ = step5_both(weights, retina, stab_frames())
    jcfg = override(PipelineConfig(), {"model.dtype": "float32", "infer.lnet_batch_size": 4})
    assert not jcfg.model.reuse_detections
    jpipe = LipSyncPipeline(jcfg, PipelineModels(enet=weights["enet"],
                                                 final_enhancer=jax_final(weights, retina)))
    want = jpipe.synthesize(stab, jnp.asarray(x["mel"]), x["frames"], x["coords"], 25.0,
                            boxes_full=x["boxes"], lms_stab=x["lms_stab"])
    tcfg = t_cfg.PipelineConfig(model=t_cfg.ModelConfig(dtype="float32"),
                                infer=t_cfg.InferenceConfig(lnet_batch_size=4))
    assert not tcfg.model.reuse_detections
    tpipe = t_inf.LipSyncPipeline(
        tcfg, t_inf.PipelineModels(enet=load(TENet(**ENET_KW), TW.enet_from_jax(weights["enet"])),
                                   final_enhancer=port_final(weights, retina)),
        device="cpu")
    got = tpipe.synthesize(stab, torch.from_numpy(x["mel"].copy()), x["frames"], x["coords"],
                           25.0, boxes_full=x["boxes"], lms_stab=x["lms_stab"])
    assert want.shape[1:] == (2 * x["frames"].shape[1], 2 * x["frames"].shape[2], 3)
    assert_close_frames(got, want)


@pytest.mark.parametrize("reuse", [False, True])
def test_enhance_reference_calls_the_hook_as_run_does(reuse):
    """``enhance_reference`` is the body of s2v_tpu's compute_enh: the hook
    on the frames alone, or, under reuse_detections, with the 5-point
    landmarks and boxes of one landmark sweep, whose landmarks it returns."""
    calls = []

    def hook(frames, **kw):
        calls.append(kw)
        return torch.as_tensor(frames) + 1

    pipe = t_inf.LipSyncPipeline(
        t_cfg.PipelineConfig(model=t_cfg.ModelConfig(reuse_detections=reuse)),
        t_inf.PipelineModels(ref_enhancer=hook), device="cpu")
    lms = synthetic_landmarks(N, 256, 256)
    boxes = np.tile(np.asarray([60, 50, 196, 220], np.float32), (N, 1))
    pipe.extract_landmarks = lambda frames, return_boxes: (lms, boxes)
    frames = stab_frames()
    enhanced, got_lms = pipe.enhance_reference(frames)
    np.testing.assert_array_equal(enhanced.numpy(), frames + 1)
    if not reuse:
        assert calls == [{}] and got_lms is None
        return
    assert got_lms is lms and set(calls[0]) == {"landmarks5", "det_boxes"}
    np.testing.assert_allclose(calls[0]["landmarks5"], t_fan.lm68_to_lm5(lms))
    np.testing.assert_array_equal(calls[0]["det_boxes"], boxes)


def test_enhancer_refuses_what_the_port_does_not_run(weights):
    """No detector and no landmarks; GPEN asked for but not given."""
    frames = stab_frames()[:1]
    models = port_models(weights, weights["retinaface"])
    del models["retinaface"]
    enh = t_enh.FaceEnhancer(models, in_size=IN_SIZE, dtype="float32", parse_size=PARSE,
                             device="cpu")
    with pytest.raises(ValueError, match="retinaface"):
        enh.process_batch(frames, face_enhance=False)
    lm5 = lm68_to_lm5(synthetic_landmarks(1, 256, 256)).astype(np.float32)
    with pytest.raises(ValueError, match="facegan"):
        enh.process_batch(frames, landmarks5=lm5)
