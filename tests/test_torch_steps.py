"""Steps 1-3 and the chained Step 6 of the port's ``LipSyncPipeline``
against s2v_tpu's on one slim clip, f32 on the CPU: S3FD at full width
(the face-class bias of its stride-4 head raised by 2, so that random
weights find a face in every frame without saturating the scores), FAN
with one hourglass module (s2v_tpu's pipeline builds ``FAN()``, patched to
one module for the test as tests/test_pipeline_e2e.py does), ReconNet,
DNet and ENet at the slim widths of tests/test_pipeline_e2e.py. Landmarks
that set geometry (the FFHQ crop, the 3DMM alignment) are injected, as
tests/test_pipeline_e2e.py injects them.

Decodes are argmaxes, so boxes and landmarks are compared where the top-2
margin of their score or heatmap exceeds 1e-5 (of the heatmaps' scale):
ten times the largest difference measured between the two packages' S3FD
scores (3.8e-6) and heatmaps (8.6e-7 of their scale) on these models; at
least 95% of the landmarks must qualify. Step 6 builds its reference faces
from all the landmarks it sweeps, so the clip is chosen so that every
margin of the stabilised frames holds, which that test asserts, with room
to spare: its seed (41) gives margins of 5.7 times their tolerance or more
(the boxes' 19.1; the test prints them). The landmarks that set geometry
come from ``fixed_landmarks``, whose jitter has a seed of its own: drawn
from test_pipeline_e2e's shared RandomState they depended on the files an
xdist worker ran before, and so did the margins. Then: boxes
and landmarks within 1e-3 px (a flipped argmax or +-0.25 step would move a
landmark by a quarter of a heatmap pixel, over 0.25 px here; the rest is
f32 rounding through the boxes); crops and stabilised frames
within one gray level (both sides compute in f32 and truncate); 3DMM
coefficients within 1e-4 of their scale and the alignment parameters
exactly; output frames as in tests/test_torch_pipeline.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s2v_tpu.pipeline.inference as j_inf
from s2v_torch.models import fan as t_fan
from s2v_torch.models import s3fd as t_s3fd
from s2v_torch.models.dnet import DNet as TDNet
from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models.resnet import ReconNet as TReconNet
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.pipeline import enhance as t_enh
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.audio import melspectrogram
from s2v_tpu.models import DNet, ENet
from s2v_tpu.models.fan import FAN
from s2v_tpu.models.resnet import ReconNet
from s2v_tpu.models.s3fd import S3FD
from s2v_tpu.utils.config import PipelineConfig, override
from test_torch_models import load
from test_torch_pipeline import ENET_KW, PARSE_KW, RRDB_KW, assert_close_frames
from torch_parity import fixed_landmarks, one_torch_thread, random_variables

N, H, W = 4, 256, 256
LM3D = np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                   [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float64)
RECON_KW = dict(layers=(1, 1, 1, 1), base_planes=8)
DNET_KW = dict(descriptor_nc=16, warp_base_nc=8, edit_base_nc=8, max_nc=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def one_module_fan():
    return FAN(num_modules=1)


@pytest.fixture(scope="module")
def pipes():
    s3fd = random_variables(S3FD(), (1, 128, 128, 3), seed=50)
    s3fd["params"]["conv3_3_norm_mbox_conf"]["bias"][3] += 2.0
    v = dict(s3fd=s3fd,
             fan=random_variables(FAN(num_modules=1), (1, 256, 256, 3), seed=51),
             recon=random_variables(ReconNet(**RECON_KW), (1, 224, 224, 3), seed=52),
             dnet=random_variables(DNet(**DNET_KW), (1, 256, 256, 3), (1, 26, 73), seed=53),
             enet=random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6),
                                   (1, 96, 96, 3), seed=54))
    expression = (np.random.RandomState(55).randn(64) * 0.1).astype(np.float32)
    jcfg = override(PipelineConfig(), {"model.dtype": "float32", "infer.lnet_batch_size": 4})
    jpipe = j_inf.LipSyncPipeline(jcfg, j_inf.PipelineModels(
        **v, lm3d=LM3D, expression=expression))
    port = t_inf.PipelineModels(
        s3fd=load(t_s3fd.S3FD(), TW.s3fd_from_jax(v["s3fd"])),
        fan=load(t_fan.FAN(num_modules=1), TW.fan_from_jax(v["fan"])),
        recon=load(TReconNet(**RECON_KW), TW.recon_from_jax(v["recon"])),
        dnet=load(TDNet(**DNET_KW), TW.dnet_from_jax(v["dnet"])),
        enet=load(TENet(**ENET_KW), TW.enet_from_jax(v["enet"])),
        lm3d=LM3D, expression=expression)
    tcfg = t_cfg.PipelineConfig(model=t_cfg.ModelConfig(dtype="float32"),
                                infer=t_cfg.InferenceConfig(lnet_batch_size=4))
    return jpipe, t_inf.LipSyncPipeline(tcfg, port, device="cpu")


def jax_fan_one_module(fn, *args, **kw):
    """s2v_tpu's landmark program with a one-module FAN."""
    orig = j_inf.FAN
    j_inf.FAN = one_module_fan
    try:
        return fn(*args, **kw)
    finally:
        j_inf.FAN = orig


def clip(seed=41):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255.0 / W, yy * 255.0 / H, (xx + yy) * 127.0 / (H + W)], -1)
    return np.clip(base[None] + rng.randn(N, H, W, 3) * 30, 0, 255).astype(np.uint8)


@torch.no_grad()
def margins(tpipe, frames):
    """Top-2 margins of the S3FD score per frame and of each FAN heatmap
    (at the port's boxes), from the port's modules, with their tolerances."""
    x = torch.tensor(frames).permute(0, 3, 1, 2).float()
    outs = tpipe.models.s3fd(x.flip(1) - torch.tensor(t_s3fd.BGR_MEAN).view(1, 3, 1, 1))
    _, scores = t_s3fd.decode_all(outs)
    top = scores.topk(2, dim=1).values
    boxes, _ = t_s3fd.best_boxes(outs)
    centers, scales = t_fan.box_to_center_scale(boxes)
    hm = tpipe.models.fan(t_fan.crop_faces_batched(x, centers, scales))
    htop = hm.flatten(2).topk(2, dim=2).values
    return ((top[:, 0] - top[:, 1]).numpy(), 1e-5,
            (htop[..., 0] - htop[..., 1]).numpy(), 1e-5 * max(1.0, hm.abs().max().item()))


@pytest.fixture(scope="module")
def chain(pipes):
    """Both pipelines through Steps 1-3 on the same clip; each step after
    the first takes the JAX side's output of the step before."""
    jpipe, tpipe = pipes
    frames = clip()
    out = {"frames": frames}
    out["j_lm"], out["j_boxes"] = jax_fan_one_module(jpipe.extract_landmarks, frames,
                                                     return_boxes=True)
    out["t_lm"], out["t_boxes"] = tpipe.extract_landmarks(frames, return_boxes=True)
    out["margins"] = margins(tpipe, frames)
    first_lm = fixed_landmarks(1, H, W, seed=56)[0]
    out["j_f256"], out["j_coords"] = jpipe.ffhq_crop(frames, first_lm)
    out["t_f256"], out["t_coords"] = tpipe.ffhq_crop(frames, first_lm)
    f256 = out["j_f256"]
    out["j_lm256"] = jax_fan_one_module(jpipe.extract_landmarks, f256)
    out["t_lm256"] = tpipe.extract_landmarks(torch.tensor(f256))  # a tensor goes too
    out["margins256"] = margins(tpipe, f256)
    lm = fixed_landmarks(N, 256, 256, seed=57)
    lm[1] = -1.0  # the no-face sentinel: lm3d's own landmarks
    out["j_sem"] = jpipe.extract_coeffs(f256, lm, batch=4)
    out["t_sem"] = tpipe.extract_coeffs(f256, lm, batch=3)
    for one_shot in (False, True):
        out[f"j_stab{one_shot}"] = jpipe.stabilize(f256, out["j_sem"], batch=4, one_shot=one_shot)
        out[f"t_stab{one_shot}"] = tpipe.stabilize(f256, out["j_sem"], batch=3,
                                                   one_shot=one_shot)
    return out


def assert_detections_match(j_lm, t_lm, margin_info, j_boxes=None, t_boxes=None,
                            every=False):
    """Boxes of frames whose score margin holds, then landmarks whose
    heatmap margin holds too; at least 95% of them (all with ``every``)."""
    box_margin, box_tol, hm_margin, hm_tol = margin_info
    held = (box_margin > box_tol)[:, None] & (hm_margin > hm_tol)
    assert held.all() if every else held.mean() >= 0.95, (box_margin.min(), hm_margin.min())
    if j_boxes is not None:
        f = box_margin > box_tol
        np.testing.assert_allclose(t_boxes[f], j_boxes[f], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_lm[held], j_lm[held], rtol=0, atol=1e-3)


def test_step1_landmarks_and_boxes_match_jax(chain):
    assert chain["t_lm"].shape == (N, 68, 2) and chain["t_boxes"].shape == (N, 4)
    assert_detections_match(chain["j_lm"], chain["t_lm"], chain["margins"],
                            chain["j_boxes"], chain["t_boxes"])


def test_ffhq_crop_matches_jax(chain):
    assert chain["t_coords"] == chain["j_coords"]
    d = np.abs(chain["t_f256"].astype(np.int32) - chain["j_f256"].astype(np.int32))
    assert chain["t_f256"].shape == (N, 256, 256, 3) and d.max() <= 1


def test_landmarks_of_the_crops_match_jax(chain):
    assert_detections_match(chain["j_lm256"], chain["t_lm256"], chain["margins256"])


def test_extract_coeffs_matches_jax(chain):
    got, want = chain["t_sem"], chain["j_sem"]
    assert got.shape == (N, 262)
    np.testing.assert_array_equal(got[:, 257:], want[:, 257:])
    np.testing.assert_allclose(got[:, :257], want[:, :257], rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("one_shot", [False, True])
def test_stabilize_matches_jax(chain, one_shot):
    got, want = chain[f"t_stab{one_shot}"], chain[f"j_stab{one_shot}"]
    assert got.shape == (N, 256, 256, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert want.std() > 1.0


def test_chained_synthesize_detects_when_nothing_is_supplied(pipes, chain):
    """Step 6 on Step 3's output with boxes_full=None (a detection sweep on
    the full frames) and lms_stab=None (a landmark sweep on the stabilised
    frames), no final stage."""
    jpipe, tpipe = pipes
    stab = chain["j_stabFalse"]
    box_margin, box_tol, hm_margin, hm_tol = held = margins(tpipe, stab)
    print(f"stabilised frames' margins over their tolerance: boxes "
          f"{box_margin.min() / box_tol:.1f}, heatmaps {hm_margin.min() / hm_tol:.1f}")
    assert_detections_match(jax_fan_one_module(jpipe.extract_landmarks, stab),
                            tpipe.extract_landmarks(stab), held, every=True)
    np.testing.assert_allclose(tpipe.detect_boxes(chain["frames"]),
                               jpipe.detect_boxes(chain["frames"]), atol=1e-3)
    t = np.arange(int(0.3 * 16000)) / 16000.0
    mel = np.array(melspectrogram(jnp.asarray((0.5 * np.sin(2 * np.pi * 200 * t))
                                              .astype(np.float32))))
    want = jax_fan_one_module(jpipe.synthesize, stab, jnp.asarray(mel), chain["frames"],
                              chain["j_coords"], 25.0)
    got = tpipe.synthesize(stab, torch.from_numpy(mel), chain["frames"], chain["j_coords"],
                           25.0)
    assert want.shape[1:] == (H, W, 3)
    assert_close_frames(got, want)


def test_detection_oom_halves_the_batch(pipes):
    """The face_detect back-off: a device OOM restarts the sweep at half
    the batch; the boxes do not change."""
    _, tpipe = pipes
    frames = clip()[:, :128, :128]
    want = tpipe.detect_boxes(frames)
    real, seen = tpipe.models.s3fd, []

    class Tight(torch.nn.Module):
        def forward(self, x):
            seen.append(len(x))
            if len(x) > 1:
                raise torch.cuda.OutOfMemoryError("out of memory")
            return real(x)

    tpipe.models.s3fd = Tight()
    try:
        got = tpipe.detect_boxes(frames, batch=4)
    finally:
        tpipe.models.s3fd = real
    assert seen == [4, 2, 1, 1, 1, 1]
    np.testing.assert_array_equal(got, want)


def test_missing_face_and_missing_landmarks_raise(pipes):
    _, tpipe = pipes
    real = tpipe.models.s3fd
    frames = clip()[:2, :64, :64]
    # a head that scores no face anywhere
    dead = load(t_s3fd.S3FD(), {k: v.clone() for k, v in real.state_dict().items()})
    with torch.no_grad():
        dead.conv3_3_norm_mbox_conf.bias[3] -= 100.0
        for name in ("conv4_3_norm", "conv5_3_norm", "fc7", "conv6_2", "conv7_2"):
            getattr(dead, f"{name}_mbox_conf").bias[1] -= 100.0
    tpipe.models.s3fd = dead
    try:
        with pytest.raises(ValueError, match="Face not detected in frame 0"):
            tpipe.extract_landmarks(frames)
    finally:
        tpipe.models.s3fd = real
    # reuse_detections without Step-1 landmarks: the final enhancer gets none
    # and must detect, which one without RetinaFace refuses
    final = t_enh.FaceEnhancer({"parsenet": TParseNet(**PARSE_KW), "srmodel": TRRDBNet(**RRDB_KW)},
                               in_size=64, dtype="float32", parse_size=64, device="cpu")
    hooked = t_inf.LipSyncPipeline(
        t_cfg.PipelineConfig(model=t_cfg.ModelConfig(reuse_detections=True)),
        t_inf.PipelineModels(enet=tpipe.models.enet,
                             final_enhancer=t_enh.final_enhancer_hook(final)),
        device="cpu")
    with pytest.raises(ValueError, match="'retinaface' model unless landmarks5"):
        hooked.synthesize(np.zeros((1, 256, 256, 3), np.uint8), torch.zeros(80, 40),
                          np.zeros((1, 64, 64, 3), np.uint8), (0, 64, 0, 64), 25.0,
                          boxes_full=np.asarray([[8, 8, 56, 56]], np.float32),
                          lms_stab=fixed_landmarks(1, 256, 256, seed=58))
