"""``model.detector_dtype=bfloat16`` in the port's detectors against
s2v_tpu's bf16 detectors, on the CPU, on the same random weights:

- the landmark sweep (``LipSyncPipeline.extract_landmarks``: S3FD at full
  width, FAN with one hourglass module, tests/test_torch_steps.py's random
  weights) on four dark noisy 256^2 frames with one bright block each;
  S3FD's face bias is not raised here: a raised bias saturates the scores,
  and s2v_tpu's bf16 softmax then rounds the best anchors to ties;
- RetinaFace (cfg_mnet, random weights: scores near 0.5, not saturated) as
  the mouth tail's ``GFPGANRestorer`` runs it;
- the tail's ParseNet (tests/test_torch_pipeline.py's slim widths, random
  weights) as ``MouthRestorer`` runs it under the restorer's ``det_dtype``,
  on the face-box crops it makes of the tail's frames. Its logits come out
  bf16, and its own bf16-vs-f32 difference (mean) lies within half and
  twice s2v_tpu's, so an f32 ParseNet (no difference) fails. The two
  packages' bf16 roundings are nearly independent (their errors correlate
  by about 0.2), so the port's bf16 logits are held to s2v_tpu's bf16
  logits within 1.5 times s2v_tpu's own bf16-vs-f32 difference (mean;
  independent errors of one size give sqrt(2)), and the mouth mask agrees
  exactly wherever the top-2 margin of s2v_tpu's bf16 logits exceeds the
  largest difference of the two bf16 runs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2v_tpu.models.fan as j_fan
import s2v_tpu.models.s3fd as j_s3fd
from s2v_torch.device import precision
from s2v_torch.models import fan as t_fan
from s2v_torch.models.parsenet import MOUTH_COLORMAP
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models import retinaface as t_rf
from s2v_torch.models import s3fd as t_s3fd
from s2v_torch.models.gfpgan import GFPGANv1Clean as TGFPGAN
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.pipeline import restoration as TR
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models import retinaface as j_rf
from s2v_tpu.models.parsenet import ParseNet
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_models import load
from test_torch_pipeline import PARSE, PARSE_KW
from test_torch_restoration import tail_frames
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


BF16 = jnp.bfloat16
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sweep():
    s3fd = random_variables(j_s3fd.S3FD(), (1, 128, 128, 3), seed=50)
    fan = random_variables(j_fan.FAN(num_modules=1), (1, 256, 256, 3), seed=51)
    frames = block_frames()
    x = frames.astype(np.float32)

    @functools.partial(jax.jit, static_argnums=3)
    def jax_sweep(vs, vf, x, dt):  # s2v_tpu's landmark program, convs in ``dt``
        outs = j_s3fd.S3FD().apply(vs, (x[..., ::-1] - jnp.asarray(j_s3fd.BGR_MEAN)).astype(dt))
        outs = jax.tree_util.tree_map(lambda t: t.astype(jnp.float32), outs)
        _, scores = j_s3fd.decode_all(outs)
        boxes, _ = j_s3fd.best_boxes(outs)
        centers, scales = j_fan.box_to_center_scale(boxes)
        crops = j_fan.crop_faces_batched(x, centers, scales)
        hm = j_fan.FAN(num_modules=1).apply(vf, crops.astype(dt)).astype(jnp.float32)
        return scores, boxes, crops, hm, j_fan.heatmaps_to_landmarks(hm, centers, scales), scales

    scores, boxes, crops, hm, lms, scales = (np.array(t) for t in jax_sweep(s3fd, fan, x, BF16))
    lms32 = np.asarray(jax_sweep(s3fd, fan, x, jnp.float32)[4])
    hm = hm.transpose(0, 3, 1, 2)  # NCHW, as the port's
    models = t_inf.PipelineModels(s3fd=load(t_s3fd.S3FD(), TW.s3fd_from_jax(s3fd)),
                                  fan=load(t_fan.FAN(num_modules=1), TW.fan_from_jax(fan)))
    cfg = t_cfg.PipelineConfig(model=t_cfg.ModelConfig(detector_dtype="bfloat16"))
    pipe = t_inf.LipSyncPipeline(cfg, models, device="cpu")
    t_lms, t_boxes = pipe.extract_landmarks(frames, return_boxes=True)
    with torch.no_grad(), precision("detector", CPU, "bfloat16"):  # the port's raw bf16 outputs
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        outs = models.s3fd(xt.flip(1) - torch.tensor(t_s3fd.BGR_MEAN).view(1, 3, 1, 1))
        t_hm = models.fan(torch.from_numpy(crops).permute(0, 3, 1, 2)).float().numpy()
    _, t_scores = t_s3fd.decode_all([(c.float(), r.float()) for c, r in outs])
    return dict(scores=scores, boxes=boxes, hm=hm, lms=lms, lms32=lms32, scales=scales,
                t_lms=t_lms,
                t_boxes=t_boxes, t_scores=t_scores.numpy(), t_hm=t_hm)


def block_frames(seed=3):
    """Dark noise with one bright 48x40 block per frame: random S3FD weights
    score the anchors at the block well above the rest."""
    rng = np.random.RandomState(seed)
    frames = np.clip(rng.randn(4, 256, 256, 3) * 10 + 60, 0, 255)
    for f in frames:
        y, x = rng.randint(40, 180, 2)
        f[y:y + 48, x:x + 40] = 240
    return frames.astype(np.uint8)


def top2_margin(a, axis):
    s = np.sort(a, axis=axis)
    return np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)


def test_landmark_sweep_in_bf16_matches_jax(sweep):
    s = sweep
    b, n = s["hm"].shape[:2]
    score_diff = np.abs(s["t_scores"] - s["scores"]).max()
    hm_diff = np.abs(s["t_hm"] - s["hm"]).reshape(b, n, -1).max(2)  # per heatmap
    box_ok = top2_margin(s["scores"], 1) > score_diff
    lm_ok = box_ok[:, None] & (top2_margin(s["hm"].reshape(b, n, -1), 2) > hm_diff)
    print(f"bf16 sweep: score diff {score_diff:.3g}, heatmap diff up to {hm_diff.max():.3g}; "
          f"{box_ok.sum()}/{box_ok.size} boxes, {lm_ok.sum()}/{lm_ok.size} landmarks qualify")
    assert box_ok.mean() >= 0.75 and lm_ok.mean() >= 0.1
    np.testing.assert_allclose(s["t_boxes"][box_ok], s["boxes"][box_ok], rtol=0, atol=0.5)
    half = np.broadcast_to(200.0 * s["scales"][:, None, None] / 64 / 2, s["lms"].shape)
    d = np.abs(s["t_lms"] - s["lms"])
    assert (d[lm_ok] <= half[lm_ok] + 0.1).all(), d[lm_ok].max()
    # all landmarks: off by more than half a heatmap step no more often
    # than twice as often as s2v_tpu's own bf16 run is off its f32 run
    off = (d > half + 0.1).any(-1).mean()
    own = (np.abs(s["lms"] - s["lms32"]) > half + 0.1).any(-1).mean()
    print(f"bf16 sweep: landmarks off port vs jax {off:.3f}, jax bf16 vs f32 {own:.3f}")
    assert off <= 2 * own + 0.02


def test_retinaface_in_bf16_matches_jax():
    retina = random_variables(j_rf.retinaface_mnet(), (1, 128, 128, 3), seed=92)
    frames = tail_frames()
    x = frames.astype(np.float32)

    @jax.jit
    def jax_detect(v, x):  # GFPGANRestorer's detect with det_dtype bfloat16
        outs = j_rf.retinaface_mnet().apply(
            v, (x[..., ::-1] - jnp.asarray(j_rf.RETINA_MEAN)).astype(BF16))
        outs = tuple(o.astype(jnp.float32) for o in outs)
        return outs[1][..., 1], j_rf.detect_faces(outs, x.shape[1:3], 0.9)

    scores, (boxes, landms, _) = jax_detect(retina, x)
    scores, boxes, landms = np.asarray(scores), np.asarray(boxes), np.asarray(landms)
    model = load(t_rf.retinaface_mnet(), TW.retinaface_from_jax(retina))
    restorer = TR.GFPGANRestorer({"gfpgan": TGFPGAN(out_size=64, **SLIM_GFPGAN_KW),
                                  "retinaface": model}, det_dtype="bfloat16", device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    t_boxes, t_landms, _ = restorer._detect(xt)
    with torch.no_grad(), precision("detector", CPU, "bfloat16"):  # its raw scores
        outs = model(xt.flip(1) - torch.tensor(j_rf.RETINA_MEAN).view(1, 3, 1, 1))
    diff = np.abs(outs[1][..., 1].float().numpy() - scores).max()
    ok = top2_margin(scores, 1) > diff
    print(f"bf16 RetinaFace: score diff {diff:.3g}, {ok.sum()}/{ok.size} frames qualify")
    assert ok.mean() >= 0.5
    np.testing.assert_allclose(t_boxes.numpy()[ok], boxes[ok], rtol=0, atol=0.5)
    np.testing.assert_allclose(t_landms.numpy()[ok], landms[ok], rtol=0, atol=0.5)


def test_parsenet_in_bf16_matches_jax():
    v = random_variables(ParseNet(**PARSE_KW), (1, PARSE, PARSE, 3), seed=93)
    frames = torch.from_numpy(tail_frames()).permute(0, 3, 1, 2).float()
    n, _, h, w = frames.shape
    boxes = torch.tensor([[8.0 + 3 * i, 6.0 + 2 * i, w - 10.0 - i, h - 7.0 - 2 * i]
                          for i in range(n)])
    parsenet = load(TParseNet(**PARSE_KW), TW.parsenet_from_jax(v))
    seen = {}
    parsenet.register_forward_hook(
        lambda m, args, out: seen.update(crop=args[0].float(), logits=out[0]))
    mouth = TR.make_mouth_restorer(
        {"retinaface": t_rf.retinaface_mnet(), "parsenet": parsenet,
         "gfpgan": TGFPGAN(out_size=64, **SLIM_GFPGAN_KW)}, parse_size=PARSE,
        det_dtype="bfloat16", device="cpu")
    mouth._blend(frames, frames, boxes)  # ParseNet on the restored (here: input) boxes
    assert seen["logits"].dtype == torch.bfloat16
    got = seen["logits"].float().permute(0, 2, 3, 1).numpy()
    with torch.no_grad():
        got32 = parsenet(seen["crop"])[0].permute(0, 2, 3, 1).numpy()
    x = jnp.asarray(seen["crop"].permute(0, 2, 3, 1).numpy())
    run = jax.jit(lambda v, x: ParseNet(**PARSE_KW).apply(v, x)[0].astype(jnp.float32))
    want, want32 = np.asarray(run(v, x.astype(BF16))), np.asarray(run(v, x))
    diff, gap, own = (np.abs(a - b) for a, b in ((got, want), (want, want32), (got, got32)))
    ok = top2_margin(want, -1) > diff.max()
    print(f"bf16 ParseNet: logits port vs jax mean {diff.mean():.4f} max {diff.max():.3g}; "
          f"jax bf16 vs f32 mean {gap.mean():.4f}; port bf16 vs f32 mean {own.mean():.4f}; "
          f"{ok.mean():.3f} of the pixels qualify")
    assert 0.5 * gap.mean() <= own.mean() <= 2 * gap.mean()
    assert diff.mean() <= 1.5 * gap.mean()
    assert ok.mean() >= 0.5
    np.testing.assert_array_equal(got.argmax(-1)[ok], want.argmax(-1)[ok])
