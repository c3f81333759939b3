"""``LipSyncPipeline.run`` of the port against s2v_tpu's, f32 on the CPU,
on tests/test_torch_steps.py's slim models and clip (seed 41, FAN patched to
one module on the JAX side): the clip and the speech as files, Steps 1-3,
a Step-5 hook, the mel and Step 6, through each package's artifact cache,
to the output file.

Both sides' ``extract_landmarks`` are wrapped alike: the real sweep runs and
gives the boxes, and ``fixed_landmarks`` stand in for its landmarks, so the
geometry they set (the FFHQ crop, the 3DMM alignment, the reference faces)
is the same on both sides whatever the random FAN finds. The Step-5 hook is
a brightening by 9 gray levels on both sides (the GPEN enhancer has its own
tests). Output tolerance as tests/test_torch_pipeline.py's.

Then, on the port alone: a second run hits the cache (Steps 1-3 and 5 are
not called, the output is the same), ``re_preprocess`` recomputes them, and
``--crop`` takes effect and keys its own artifacts.
"""

import os
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_tpu.pipeline import inference as j_inf
from s2v_tpu.utils.config import override
from test_torch_pipeline import assert_close_frames
from test_torch_steps import clip, jax_fan_one_module, pipes  # noqa: F401 (a fixture)
from torch_parity import fixed_landmarks

STEPS = ("extract_landmarks", "ffhq_crop", "extract_coeffs", "stabilize")


def fixed_geometry(extract, calls):
    """``extract_landmarks`` with its landmarks replaced by fixed ones of the
    frames' size; the boxes stay the sweep's."""
    def run(frames, batch=32, return_boxes=False):
        calls.append("extract_landmarks")
        lms, boxes = extract(frames, batch=batch, return_boxes=True)
        n, h, w = len(lms), frames.shape[1], frames.shape[2]
        fixed = fixed_landmarks(n, h, w, seed=56 if (h, w) != (256, 256) else 57)
        return (fixed, boxes) if return_boxes else fixed
    return run


def counted(fn, name, calls):
    def run(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    return run


def brighten_torch(frames, **kw):
    return (torch.as_tensor(frames).int() + 9).clamp(0, 255).to(torch.uint8)


def brighten_jax(frames, **kw):
    return jnp.clip(jnp.asarray(frames).astype(jnp.int32) + 9, 0, 255).astype(jnp.uint8)


def write_inputs(tmp_path, frames, seconds=0.3):
    np.savez(tmp_path / "face.npz", frames=frames, fps=25.0)
    t = np.arange(int(seconds * 16000)) / 16000.0
    pcm = (0.5 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           * 32767).astype(np.int16)
    with wave.open(str(tmp_path / "speech.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(tmp_path / "face.npz"), str(tmp_path / "speech.wav")


@pytest.fixture(scope="module")
def port_pipeline(pipes):  # noqa: F811
    """The port's pipeline of ``pipes`` with a counting Step-5 hook and
    counting steps; ``calls`` lists what ran."""
    _, tpipe = pipes
    calls = []
    models = t_inf.PipelineModels(**{**vars(tpipe.models),
                                     "ref_enhancer": counted(brighten_torch, "step5", calls)})

    def make(**infer):
        cfg = t_cfg.override(tpipe.cfg, {f"infer.{k}": v for k, v in infer.items()})
        pipe = t_inf.LipSyncPipeline(cfg, models, device="cpu")
        pipe.extract_landmarks = fixed_geometry(pipe.extract_landmarks, calls)
        for name in STEPS[1:]:
            setattr(pipe, name, counted(getattr(pipe, name), name, calls))
        return pipe

    return make, calls


def test_run_matches_jax(pipes, port_pipeline, tmp_path):  # noqa: F811
    jpipe, _ = pipes
    make, _ = port_pipeline
    face, audio = write_inputs(tmp_path, clip())
    jcfg = override(jpipe.cfg, {"infer.tmp_dir": str(tmp_path / "jax_tmp")})
    jrun = j_inf.LipSyncPipeline(jcfg, j_inf.PipelineModels(
        **{**vars(jpipe.models), "ref_enhancer": brighten_jax}))
    jrun.extract_landmarks = fixed_geometry(jrun.extract_landmarks, [])
    want = np.load(jax_fan_one_module(jrun.run, face, audio, str(tmp_path / "jax_out.npz")))
    got_path = make(tmp_dir=str(tmp_path / "port_tmp")).run(face, audio,
                                                            str(tmp_path / "port_out.npz"))
    got = np.load(got_path)
    assert got_path == str(tmp_path / "port_out.npz")
    assert float(got["fps"]) == float(want["fps"]) == 25.0
    assert got["frames"].shape[1:] == (256, 256, 3)
    assert_close_frames(got["frames"], want["frames"])
    # the same artifacts under the same names
    assert sorted(os.listdir(tmp_path / "port_tmp")) == sorted(os.listdir(tmp_path / "jax_tmp"))


def test_second_run_hits_the_cache_and_re_preprocess_recomputes(port_pipeline, tmp_path):
    make, calls = port_pipeline
    face, audio = write_inputs(tmp_path, clip())
    tmp = str(tmp_path / "tmp")
    calls.clear()
    first = np.load(make(tmp_dir=tmp).run(face, audio, str(tmp_path / "a.npz")))["frames"]
    # Step 1's sweep, the crops' sweep and the reference faces' sweep
    assert sorted(calls) == sorted(["extract_landmarks"] * 3 + list(STEPS[1:]) + ["step5"])
    names = sorted(os.listdir(tmp))
    assert [n.split("_")[1] for n in names if n != "result.npz"] == [
        "coeffs", "enhanced5", "ffhq", "landmarks", "stabilized"]
    calls.clear()
    second = np.load(make(tmp_dir=tmp).run(face, audio, str(tmp_path / "b.npz")))["frames"]
    assert calls == ["extract_landmarks"]  # Step 6's reference faces only
    np.testing.assert_array_equal(second, first)
    calls.clear()
    make(tmp_dir=tmp, re_preprocess=True).run(face, audio, str(tmp_path / "c.npz"))
    assert sorted(calls) == sorted(["extract_landmarks"] * 3 + list(STEPS[1:]) + ["step5"])
    assert sorted(os.listdir(tmp)) == names


def test_crop_takes_effect(port_pipeline, tmp_path):
    make, calls = port_pipeline
    frames = clip()
    face, audio = write_inputs(tmp_path, frames)
    tmp = str(tmp_path / "tmp")
    make(tmp_dir=tmp).run(face, audio, str(tmp_path / "full.npz"))
    uncropped = set(os.listdir(tmp))
    calls.clear()
    out = np.load(make(tmp_dir=tmp, crop=(8, -1, 16, 240)).run(
        face, audio, str(tmp_path / "crop.npz")))["frames"]
    assert out.shape[1:] == (256 - 8, 240 - 16, 3)
    assert "ffhq_crop" in calls  # a crop keys artifacts of its own
    assert len(set(os.listdir(tmp)) - uncropped) == 5
