"""The frozen reference against the port at slim widths on the CPU, a run of
each kind of cell driven with the timed path broken underneath (``correct``
must come out false), and the controls on the card."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.tests.conftest import ROOT, run_on_cpu

SEED = 2 ** 31 + 11


def limits(cell: str) -> dict:
    return {k: v["limit"] for k, v in json.loads(
        (ROOT / "portbench" / "limits" / f"{cell}.json").read_text()).items()}


def values(out: dict) -> dict:
    return {k: v["value"] for k, v in out["compared"].items()}


def test_reference_agrees_with_the_port_on_a_dub_request(weights_cache, monkeypatch):
    """One slim dub run on the CPU (where the port's generators run in f32,
    as the reference's do): the compared frames agree to one gray level."""
    out = run_on_cpu("vrt_default.dub", SEED, weights_cache, monkeypatch=monkeypatch)
    assert out["correct"] and out["failed"] == 0
    assert values(out)["frame_max_abs"] <= 1.0


def test_reference_agrees_with_the_port_over_an_r1_pair(weights_cache):
    """Slim GPEN training on the CPU: the first pair (R1 on its d_step) and
    the two after it."""
    out = run_on_cpu("gpen512_train.device_pool", SEED, weights_cache)
    v = values(out)
    assert out["correct"]
    assert v["d_loss_gap"] < 1e-5 and v["d_grad_gap"] < 1e-4
    assert v["g_loss_gap"] < 1e-5


def unchanged(trainer):
    state, d_step, g_step = trainer

    def keep(step):
        def run(state, batch):
            saved = {k: p.detach().clone() for m in (state.g, state.d, state.g_ema)
                     for k, p in m.named_parameters(prefix=str(id(m)))}
            state, metrics = step(state, batch)
            for m in (state.g, state.d, state.g_ema):
                for k, p in m.named_parameters(prefix=str(id(m))):
                    p.data.copy_(saved[k])
            return state, metrics
        return run

    return state, keep(d_step), keep(g_step)


def half(step):
    return lambda state, batch: step(state, {k: v[: len(v) // 2] for k, v in batch.items()})


def half_batch(trainer):
    state, d_step, g_step = trainer
    return state, half(d_step), half(g_step)


def half_batch_in_g_step(trainer):
    state, d_step, g_step = trainer
    return state, d_step, half(g_step)


@pytest.mark.parametrize("fault", [unchanged, half_batch, half_batch_in_g_step],
                         ids=["state_unchanged", "half_batch", "half_batch_in_g_step"])
def test_a_broken_training_step_is_not_correct(fault, weights_cache, monkeypatch):
    import s2v_torch.train.gan as gan

    make = gan.make_gan_trainer
    monkeypatch.setattr(gan, "make_gan_trainer", lambda *a, **k: fault(make(*a, **k)))
    out = run_on_cpu("gpen512_train.device_pool", SEED, weights_cache)
    v, lim = values(out), limits("gpen512_train.device_pool")
    assert not out["correct"]
    assert any(v[k] > lim[k] for k in v)


def test_an_altered_answer_is_not_correct(weights_cache, monkeypatch):
    """Each output frame's top left quarter blacked out where Step 6 makes
    it."""
    from s2v_torch.pipeline.inference import LipSyncPipeline

    synthesize = LipSyncPipeline.synthesize

    def altered(self, *a, **k):
        out = np.array(synthesize(self, *a, **k))
        h, w = out.shape[1:3]
        out[:, : h // 2, : w // 2] = 0
        return out

    monkeypatch.setattr(LipSyncPipeline, "synthesize", altered)
    out = run_on_cpu("vrt_default.dub", SEED, weights_cache, monkeypatch=monkeypatch)
    assert not out["correct"]


@pytest.mark.cuda
def test_the_training_control_fails_on_the_card(card):
    """The reference in TF32 against the reference in f32 (the configuration
    states f32 without TF32), GPEN-512 at the cell's own size: the control
    fails one of the cell's numbers."""
    import torch

    from portbench.core import registry

    sizes, cfg = registry.config("gpen512_train")
    traffic = registry.traffic("device_pool")
    drv = registry.driver("gan_pool")
    lim = limits("gpen512_train.device_pool")
    weights = cfg.make_weights(torch, sizes, 5, "cuda")
    pool = drv.pool(torch, sizes, traffic, 5, "cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    want = drv.first_pairs(torch, cfg.reference_trainer(torch, sizes, weights, "cuda"), pool,
                           from_adam=False)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = drv.first_pairs(torch, cfg.reference_trainer(torch, sizes, weights, "cuda"), pool,
                              from_adam=False)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    v = drv.gaps(low, want)
    assert any(v[k] > lim[k] for k in v), v


@pytest.mark.cuda
def test_the_inference_control_fails_on_the_card(card):
    """The reference with its bf16 networks in fp8 and its f32 networks in
    TF32 against the reference, at the cell's own size: four output frames
    of a 50-frame 512^2 clip's request."""
    import torch

    from portbench.core import compare, registry, synth

    sizes, cfg = registry.config("vrt_default")
    traffic = registry.traffic("dub")
    weights = cfg.ensure_weights(torch, sizes, ROOT / "portbench" / ".cache" / "weights", "cuda")
    gen = synth.generator(torch, 3, "cuda")
    s = sizes["frame_size"]
    frames = synth.clip_frames(torch, traffic["clip_frames"], s, s, gen, "cuda")
    wav = synth.speech(torch, traffic["speech_seconds"], gen)
    pick = [0, 15, 30, 45]
    want = cfg.Reference(torch, sizes, weights, "cuda").outputs(frames, wav, pick)
    low = cfg.Reference(torch, sizes, weights, "cuda", below=True).outputs(frames, wav, pick)
    v, lim = compare.frames(low, want), limits("vrt_default.dub")
    assert any(v[k] > lim[k] for k in v), v


def test_a_traced_run_reports_its_per_layer_metrics(weights_cache):
    """A traced slim training run on the CPU: the spans' metrics, the
    profile's window and breakdown (no device work there, so no kernel's
    roofline), and the check as in an untraced run."""
    out = run_on_cpu("gpen512_train.device_pool", SEED, weights_cache, trace=1)
    assert out["correct"]
    assert {"g_step_ms", "d_step_ms", "mfu.train", "device_idle_pct.train"} <= set(out["metrics"])
    assert not any(k.endswith("_roofline.train") for k in out["metrics"])
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
