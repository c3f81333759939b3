"""The port's slice end to end against the JAX package: Step 6
(``LipSyncPipeline.synthesize`` with detections reused) and the final hook
(GPEN + RealESRNet x2, ``FaceEnhancer.process_batch`` with ``use_sr``) on
the same slim weights, the same injected frames, boxes and landmarks and the
same mel, in f32 on the CPU.

A second case gives the clip fewer frames than mel chunks, so frames and
mel chunks ping-pong past the clip's end (output i takes frame and chunk
``frame_index(i)``, as the JAX package does).

Tolerance on the uint8 output: both sides compute in f32 and truncate to
uint8, so a subpixel whose value sits on an integer boundary may differ by
one gray level (measured: 0.006% of subpixels, none by more than 1). The
test allows 0.1% of subpixels to differ by more than 1, for a ParseNet
argmax that flips on a near-tie, and a mean difference under 0.01.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.pipeline import enhance as t_enh
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.audio import melspectrogram
from s2v_tpu.models import ENet
from s2v_tpu.models.gpen import FullGenerator
from s2v_tpu.models.parsenet import ParseNet
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.pipeline.enhance import FaceEnhancer
from s2v_tpu.pipeline.inference import LipSyncPipeline, PipelineModels
from s2v_tpu.utils.config import PipelineConfig, override
from torch_parity import fixed_landmarks, one_torch_thread, random_variables

N, H, W = 6, 96, 112
IN_SIZE, PARSE = 64, 128
ENET_KW = dict(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
               lnet_base_nc=8, lnet_max_nc=32)
GPEN_KW = dict(size=IN_SIZE, narrow=0.25, channel_multiplier=0.5, style_dim=64, n_mlp=2)
PARSE_KW = dict(base_ch=16, max_ch=32, min_ch=8, res_depth=2)
RRDB_KW = dict(scale=2, num_feat=16, num_block=2, num_grow_ch=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def slice_inputs(n=N, seconds=0.35):
    rng = np.random.RandomState(7)
    frames = (rng.rand(n, H, W, 3) * 255).astype(np.uint8)
    stab = (rng.rand(n, 256, 256, 3) * 255).astype(np.uint8)
    cx, cy, s = W / 2, H / 2, min(H, W) * 0.3
    boxes = np.tile(np.asarray([cx - s, cy - s, cx + s, cy + s], np.float32), (n, 1))
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = (0.5 * np.sin(2 * np.pi * 200 * t)
           * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    mel = np.array(melspectrogram(jnp.asarray(wav)))
    return dict(stab=stab, frames=frames, mel=mel, coords=(8, 88, 10, 100),
                boxes=boxes, lms_full=fixed_landmarks(n, H, W, seed=8),
                lms_stab=fixed_landmarks(n, 256, 256, seed=9))


def synthesize_both(x):
    """The JAX package's and the port's synthesize with the final hook, on
    the same slim weights and inputs; returns (jax uint8, port uint8)."""
    v = {
        "enet": random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6),
                                 (1, 96, 96, 3), seed=11),
        "facegan": random_variables(FullGenerator(**GPEN_KW), (1, IN_SIZE, IN_SIZE, 3),
                                    seed=12, equalized=True),
        "parsenet": random_variables(ParseNet(**PARSE_KW), (1, PARSE, PARSE, 3), seed=13),
        "srmodel": random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3), seed=14),
    }

    # JAX package: the cli's final hook over FaceEnhancer(use_sr=True)
    jcfg = override(PipelineConfig(), {"model.dtype": "float32",
                                       "model.reuse_detections": "true",
                                       "infer.lnet_batch_size": 4})
    jfinal = FaceEnhancer({"retinaface": None, "facegan": v["facegan"],
                           "parsenet": v["parsenet"], "srmodel": v["srmodel"]},
                          in_size=IN_SIZE, use_sr=True, sr_scale=2, dtype="float32",
                          parse_size=PARSE)

    def jhook(frames, boxes_xyxy, **kw):
        return jfinal.process_batch(frames, face_enhance=True, possion_blending=True,
                                    bboxes=np.asarray(boxes_xyxy)[:, [1, 3, 0, 2]], **kw)

    jpipe = LipSyncPipeline(jcfg, PipelineModels(enet=v["enet"], final_enhancer=jhook))
    want = jpipe.synthesize(x["stab"], jnp.asarray(x["mel"]), x["frames"], x["coords"],
                            25.0, boxes_full=x["boxes"], lms_full=x["lms_full"],
                            lms_stab=x["lms_stab"])

    # the port, same weights through *_from_jax
    def port(cls, kw, sd):
        m = cls(**kw)
        m.load_state_dict(sd)
        return m

    final = t_enh.FaceEnhancer(
        {"facegan": port(TGPEN, GPEN_KW, TW.gpen_from_jax(v["facegan"])),
         "parsenet": port(TParseNet, PARSE_KW, TW.parsenet_from_jax(v["parsenet"])),
         "srmodel": port(TRRDBNet, RRDB_KW, TW.rrdbnet_from_jax(v["srmodel"]))},
        in_size=IN_SIZE, dtype="float32", parse_size=PARSE, device="cpu")
    tcfg = t_cfg.PipelineConfig(
        model=t_cfg.ModelConfig(dtype="float32", reuse_detections=True),
        infer=t_cfg.InferenceConfig(lnet_batch_size=4))
    tpipe = t_inf.LipSyncPipeline(
        tcfg, t_inf.PipelineModels(enet=port(TENet, ENET_KW, TW.enet_from_jax(v["enet"])),
                                   final_enhancer=t_enh.final_enhancer_hook(final)),
        device="cpu")
    got = tpipe.synthesize(x["stab"], torch.from_numpy(x["mel"].copy()), x["frames"], x["coords"],
                           25.0, boxes_full=x["boxes"], lms_full=x["lms_full"],
                           lms_stab=x["lms_stab"])
    return want, got


def assert_close_frames(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (d > 1).mean() <= 1e-3 and d.mean() < 0.01, (d.max(), (d > 1).mean(), d.mean())
    assert want.std() > 1.0  # not a constant frame


def test_synthesize_with_final_stage_matches_jax():
    want, got = synthesize_both(slice_inputs())
    assert want.shape == (6, 2 * H, 2 * W, 3)
    assert_close_frames(got, want)


def test_synthesize_fewer_frames_than_chunks_matches_jax():
    """3 frames, 0.4 s of speech (7 mel chunks): outputs 3..6 reuse frames
    and mel chunks by the ping-pong index."""
    want, got = synthesize_both(slice_inputs(n=3, seconds=0.4))
    assert want.shape == (7, 2 * H, 2 * W, 3)
    assert_close_frames(got, want)
    # frame_index(i) for i = 0..6 over 3 frames is 0 1 2 1 0 1 2, and the mel
    # chunk follows it: outputs 1 and 3 (one batch of 4) are the same
    np.testing.assert_array_equal(got[1], got[3])


def test_synthesize_one_frame_clip_matches_jax():
    """A one-frame clip (like ``infer.static``) has frame_index(i) = 0 for
    every output, so every output takes mel chunk 0 as well: the JAX package
    lip-syncs no audio past the first chunk there, and the port keeps that
    quirk. All 7 outputs are the same frame on both sides."""
    want, got = synthesize_both(slice_inputs(n=1, seconds=0.4))
    assert want.shape == (7, 2 * H, 2 * W, 3)
    assert_close_frames(got, want)
    for i in range(1, 7):
        np.testing.assert_array_equal(got[i], got[0])
        np.testing.assert_array_equal(want[i], want[0])


def test_entry_points_refuse_without_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_inf.LipSyncPipeline(t_cfg.PipelineConfig(), t_inf.PipelineModels())
    with pytest.raises(RuntimeError, match="CUDA"):
        t_enh.FaceEnhancer({}, in_size=64)
