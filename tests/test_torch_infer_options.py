"""``synthesize`` with each opt-in setting of s2v_tpu's ``infer`` against
s2v_tpu's ``LipSyncPipeline``, on the same slim weights and inputs, f32 on
the CPU (the frames, weights and raised logits of
tests/test_torch_restoration.py and tests/test_torch_step5.py):

- ``infer.without_rl1``, without and with the ``--up_face surprise``
  GANimation editor (s2v_tpu's editor geometry, ngf 64 and 6 blocks);
- ``infer.box``, past the frame's left and right edges (clamped);
- ``infer.cropped_image`` with the final hook (GPEN + RealESRNet x2, the
  Step-1 landmarks reused);
- ``model.approx_warp``, in the reference faces' warps (the sheared warp
  itself is held to s2v_tpu's in tests/test_torch_warp_shear.py, and in
  the restorer and the enhancers on the card in tests/test_torch_cuda.py).

The mouth tail's settings (the original GFPGANv1 arch and
``model.detector_dtype=bfloat16``) are in tests/test_torch_tail_options.py,
on this file's helpers. s2v_tpu's side
runs once per setting in a module fixture on one pipeline, whose compiled
programs the settings share. Tolerance on the uint8 output as
tests/test_torch_pipeline.py: within one gray level, at most 0.1% of
subpixels off by more than 1, a mean difference under 0.01.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s2v_tpu.pipeline.restoration as JR
from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.ganimation import SplitGenerator as TSplit
from s2v_torch.models import retinaface as t_rf
from s2v_torch.models.gfpgan import GFPGANv1 as TGFPGANv1
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.pipeline import restoration as TR
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models.ganimation import SplitGenerator
from s2v_tpu.pipeline.inference import LipSyncPipeline, PipelineModels
from s2v_tpu.utils.config import PipelineConfig, override
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_gfpgan_v1 import jax_v1_vars
from test_torch_models import load
from test_torch_pipeline import ENET_KW, PARSE, PARSE_KW, assert_close_frames, slice_inputs
from test_torch_restoration import N, SIZE, changed_in_boxes, level2_face
from test_torch_restoration import tail_weights  # noqa: F401 (a fixture)
from test_torch_step5 import assert_detects, jax_final, port_final
from test_torch_step5 import weights as step5_weights  # noqa: F401 (a fixture)
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


GFPGANER = dict(input_is_latent=True, different_w=True, sft_half=True)
V1_KW = dict(SLIM_GFPGAN_KW, **GFPGANER)
BOX = (10, 80, -6, 130)  # top bottom left right: x clamped to [0, 112]

SETTINGS = {
    "without_rl1": ({"infer.without_rl1": "true"}, ()),
    "up_face": ({"infer.without_rl1": "true", "infer.up_face": "surprise"}, ("editor",)),
    "box": ({"infer.box": ",".join(map(str, BOX))}, ()),
    "cropped_image": ({"infer.cropped_image": "true", "model.reuse_detections": "true"},
                      ("final",)),
    "original_arch": ({}, ("mouth",)),
    "approx_warp": ({"model.approx_warp": "true"}, ()),
    "detector_bf16": ({"model.detector_dtype": "bfloat16"}, ("mouth",)),
}


def v1_unsaturated(v, scale=0.04):
    """The GFPGANv1 tree with its decoder's ToRGB layers scaled: random
    equalized weights put most of the restored face outside [-1, 1], whose
    paste lands on integers (see tests/test_torch_restoration.py's
    ``unsaturated``)."""
    out = copy.deepcopy(v)
    for name, layer in out["params"]["stylegan_decoder"].items():
        if name.startswith("to_rgb"):
            layer["conv"]["weight"] = layer["conv"]["weight"] * scale
            layer["bias"] = layer["bias"] * scale
    return out


@pytest.fixture(scope="module")
def weights(tail_weights, step5_weights):  # noqa: F811
    v = dict(step5_weights, gfpgan=v1_unsaturated(jax_v1_vars(V1_KW, seed=90)),
             parsenet=tail_weights["parsenet"],
             ganimation=random_variables(SplitGenerator(), (1, 128, 128, 3), (1, 17), seed=91))
    v["retinaface"] = level2_face(tail_weights["retinaface"])
    # the final stage keeps its own ParseNet, as test_torch_mouth_synthesize.py's
    v["final"] = step5_weights
    return v


def cfg_of(setting):
    return {"model.dtype": "float32", "infer.lnet_batch_size": "4", **SETTINGS[setting][0]}


def jax_mouth(v, cfg):
    """s2v_tpu's mouth hook as its cli builds it (the original arch, its
    options from ``cfg``), with its restorer in f32."""
    restorer = JR.GFPGANRestorer({"retinaface": v["retinaface"], "gfpgan": v["gfpgan"]},
                                 arch="original", chunk=N, size=SIZE, dtype="float32",
                                 approx_warp=cfg.model.approx_warp,
                                 det_dtype=cfg.model.detector_dtype)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JR, "GFPGANRestorer", lambda *a, **k: restorer)
        return JR.make_mouth_restorer(
            {"retinaface": v["retinaface"], "gfpgan": v["gfpgan"], "parsenet": v["parsenet"],
             "gfpgan_arch": "original"}, chunk=N, parse_size=PARSE, size=SIZE,
            parse_dtype=cfg.model.detector_dtype)


def port_mouth(v, cfg):
    models = dict(
        retinaface=load(t_rf.retinaface_mnet(), TW.retinaface_from_jax(v["retinaface"])),
        parsenet=load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(v["parsenet"])),
        gfpgan=load(TGFPGANv1(out_size=SIZE, **V1_KW), TW.gfpgan_v1_from_jax(v["gfpgan"])))
    return TR.make_mouth_restorer(models, chunk=3, parse_size=PARSE, dtype="float32",
                                  approx_warp=cfg.model.approx_warp,
                                  det_dtype=cfg.model.detector_dtype, device="cpu")


def recorded(hook, sink):
    def run(frames, boxes, **kw):
        sink.append((np.asarray(frames), np.asarray(boxes)))
        return hook(frames, boxes, **kw)
    return run


def synth_kw(x, cfg):
    return dict(boxes_full=x["boxes"], lms_stab=x["lms_stab"],
                lms_full=x["lms_full"] if cfg.model.reuse_detections else None)


def jax_synthesize(v, settings):
    """s2v_tpu's synthesize for each of ``settings``, on one pipeline (its
    cfg and models swapped between them). Returns {setting: (frames, the
    frames its mouth hook got)}."""
    x = slice_inputs(n=N)
    pipe = LipSyncPipeline(override(PipelineConfig(), cfg_of(settings[0])),
                           PipelineModels(enet=v["enet"]))
    out = {}
    for setting in settings:
        hooks = SETTINGS[setting][1]
        cfg = override(PipelineConfig(), cfg_of(setting))
        seen = []
        models = PipelineModels(enet=v["enet"])
        if "editor" in hooks:
            models.up_face_editor = JR.make_up_face_editor({"ganimation": v["ganimation"]},
                                                           cfg.infer.up_face)
        if "mouth" in hooks:
            models.mouth_restorer = recorded(jax_mouth(v, cfg), seen)
        if "final" in hooks:
            models.final_enhancer = jax_final(v["final"], v["retinaface"])
        pipe.cfg, pipe.models = cfg, models
        frames = pipe.synthesize(x["stab"], jnp.asarray(x["mel"]), x["frames"], x["coords"],
                                 25.0, **synth_kw(x, cfg))
        out[setting] = (frames, np.concatenate([f for f, _ in seen]) if seen else None)
    return out


@pytest.fixture(scope="module")
def jax_runs(weights):
    return jax_synthesize(weights, ["without_rl1", "up_face", "box", "cropped_image",
                                    "approx_warp"])


def port_run(v, setting):
    x = slice_inputs(n=N)
    cfg = t_cfg.override(t_cfg.PipelineConfig(), cfg_of(setting))
    hooks = SETTINGS[setting][1]
    models = t_inf.PipelineModels(enet=load(TENet(**ENET_KW), TW.enet_from_jax(v["enet"])))
    if "editor" in hooks:
        gen = load(TSplit(), TW.ganimation_from_jax(v["ganimation"]))
        models.up_face_editor = TR.make_up_face_editor({"ganimation": gen}, cfg.infer.up_face,
                                                       device="cpu")
    if "mouth" in hooks:
        models.mouth_restorer = port_mouth(v, cfg)
    if "final" in hooks:
        models.final_enhancer = port_final(v["final"], v["retinaface"])
    pipe = t_inf.LipSyncPipeline(cfg, models, device="cpu")
    return pipe.synthesize(x["stab"], torch.from_numpy(x["mel"].copy()), x["frames"],
                           x["coords"], 25.0, **synth_kw(x, cfg)), x


def assert_setting_matches(v, jax_runs, setting):
    want, pasted = jax_runs[setting]
    got, x = port_run(v, setting)
    assert want.shape == (len(want), *x["frames"].shape[1:])
    assert_close_frames(got, want)
    if pasted is not None:  # the tail found a face in every frame and changed it
        assert_detects(v["retinaface"], pasted, [True] * len(pasted))
        assert changed_in_boxes(want, pasted, np.tile([26, 18, 86, 80], (len(want), 1))) > 5.0


@pytest.mark.parametrize("setting", ["without_rl1", "up_face", "box", "cropped_image",
                                     "approx_warp"])
def test_synthesize_with_the_setting_matches_jax(weights, jax_runs, setting):
    assert_setting_matches(weights, jax_runs, setting)


def test_the_settings_change_the_output(jax_runs):
    """Each setting's output differs from the default's where it should:
    the edit from the plain composite, the fixed box, the cropped 1x frame
    outside its boxes equal to the input frames."""
    x = slice_inputs(n=N)
    plain, edit = jax_runs["without_rl1"][0], jax_runs["up_face"][0]
    assert np.abs(plain.astype(np.int32) - edit).mean() > 0.5
    box = jax_runs["box"][0]
    top, bottom, left, right = BOX
    n = len(x["frames"])
    outside = np.ones(box.shape[1:3], bool)
    outside[top:bottom, max(left, 0):min(right, box.shape[2])] = False
    for i, f in enumerate(box):  # output i takes frame i, then back: 0 1 2 3 2 1
        np.testing.assert_array_equal(f[outside], x["frames"][min(i, 2 * n - 2 - i)][outside])
    cropped = jax_runs["cropped_image"][0]
    assert cropped.shape[1:3] == x["frames"].shape[1:3]
