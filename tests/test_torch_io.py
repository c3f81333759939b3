"""The port's video and audio I/O and its artifact cache against s2v_tpu's:
``load_wav`` bit for bit (16-bit PCM at 16 kHz, resampled from 44.1 kHz,
8-bit and 32-bit, stereo), the ``.npz`` reader, writer and ``mux_audio``
round trip with the same paths, and ``ArtifactCache`` file names equal to
s2v_tpu's for the same parameters. ``defer``/``flush`` here on CPU
tensors; the pinned copies of CUDA tensors are held in
tests/test_torch_cuda.py."""

import os
import wave

import numpy as np
import pytest
import torch

from s2v_torch.io import audio_io as t_audio
from s2v_torch.io import video_io as t_video
from s2v_torch.utils.cache import ArtifactCache
from s2v_tpu.io import audio_io as j_audio
from s2v_tpu.io import video_io as j_video
from s2v_tpu.utils.cache import ArtifactCache as JCache


def write_wav(path, rate, width=2, channels=1, seconds=0.25, seed=0):
    rng = np.random.RandomState(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n)
    x = np.repeat(x[:, None], channels, 1) * np.linspace(1, 0.5, channels)
    if width == 1:
        raw = np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    else:
        dt = {2: np.int16, 4: np.int32}[width]
        raw = (x * np.iinfo(dt).max * 0.9).astype(dt)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    return str(path)


@pytest.mark.parametrize("rate, width, channels", [
    (16000, 2, 1), (44100, 2, 1), (22050, 1, 1), (16000, 4, 2), (48000, 2, 2)])
def test_load_wav_matches_jax_bit_for_bit(tmp_path, rate, width, channels):
    path = write_wav(tmp_path / "a.wav", rate, width, channels)
    got, want = t_audio.load_wav(path, 16000), j_audio.load_wav(path, 16000)
    assert got.dtype == want.dtype == np.float32 and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_non_wav_audio_without_ffmpeg_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(t_audio.shutil, "which", lambda name: None)
    path = tmp_path / "a.mp3"
    path.write_bytes(b"")
    with pytest.raises(RuntimeError, match="not a WAV file and no ffmpeg"):
        t_audio.load_wav(str(path))


@pytest.mark.parametrize("outfile", ["out.npz", "sub/out.mp4"])
def test_npz_clip_round_trip_matches_jax(tmp_path, monkeypatch, outfile):
    """Reader -> writer -> mux without ffmpeg, as on a machine with no codec:
    the same frames, fps and paths from both packages."""
    for mod in (t_video, j_video):
        monkeypatch.setattr(mod, "_FFMPEG", None)
    frames = np.random.RandomState(1).randint(0, 256, (3, 24, 32, 3)).astype(np.uint8)
    np.savez(tmp_path / "clip.npz", frames=frames, fps=30.0)
    audio = write_wav(tmp_path / "a.wav", 16000)
    paths = {}
    for name, mod in (("port", t_video), ("jax", j_video)):
        reader = mod.VideoReader(str(tmp_path / "clip.npz"))
        got = reader.read_all()
        np.testing.assert_array_equal(got, frames)
        assert reader.fps == 30.0 and tuple(reader.shape) == (24, 32)
        writer = mod.VideoWriter(str(tmp_path / name / "result.npz"), reader.fps, got.shape[1:3])
        for f in got:
            writer.write(f)
        writer.close()
        out = mod.mux_audio(writer.path, audio, str(tmp_path / name / outfile))
        data = np.load(out)
        np.testing.assert_array_equal(data["frames"], frames)
        assert float(data["fps"]) == 30.0
        paths[name] = os.path.relpath(out, tmp_path / name)
    assert paths["port"] == paths["jax"]
    np.save(tmp_path / "bare.npy", frames)
    np.testing.assert_array_equal(t_video.VideoReader(str(tmp_path / "bare.npy")).read_all(),
                                  frames)


PARAMS = [None, {"crop": (0, -1, 0, -1), "v": 3},
          {"crop": [4, -1, 4, -1], "v": 3, "one_shot": False, "exp_img": "neutral"},
          {"crop": (0, -1, 0, -1), "v": 3, "reuse_det": True}]


@pytest.mark.parametrize("params", PARAMS)
def test_cache_file_names_match_jax(tmp_path, params):
    got = ArtifactCache(str(tmp_path))._path("clip", "stabilized", params)
    assert got == JCache(str(tmp_path))._path("clip", "stabilized", params)


def test_cache_hit_miss_refresh_and_deferred_writes(tmp_path):
    cache = ArtifactCache(str(tmp_path))
    calls = []

    def compute(value):
        def fn():
            calls.append(value)
            return value
        return fn

    single = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    both = {"lm": torch.ones(2, 2), "boxes": np.zeros((2, 4), np.float32)}
    assert cache.get_or_compute("c", "single", compute(single)) is single
    assert cache.get_or_compute("c", "both", compute(both), params={"v": 3}) is both
    # a deferred write lands at flush(), after which the next call hits
    stab = torch.full((2, 4, 4, 3), 7, dtype=torch.uint8)
    assert cache.get_or_compute("c", "stab", compute(stab), defer=True) is stab
    assert not os.path.exists(cache._path("c", "stab", None))
    cache.flush()
    assert len(calls) == 3
    hit = cache.get_or_compute("c", "single", compute(None))
    np.testing.assert_array_equal(hit, single.numpy())
    hit = cache.get_or_compute("c", "both", compute(None), params={"v": 3})
    assert sorted(hit) == ["boxes", "lm"]
    np.testing.assert_array_equal(hit["lm"], np.ones((2, 2), np.float32))
    np.testing.assert_array_equal(cache.get_or_compute("c", "stab", compute(None)), stab.numpy())
    assert len(calls) == 3
    # refresh recomputes; another params hash misses
    cache.get_or_compute("c", "single", compute(single), refresh=True)
    cache.get_or_compute("c", "both", compute(both), params={"v": 4})
    assert len(calls) == 5
    # s2v_tpu's cache reads the port's artifacts
    np.testing.assert_array_equal(
        JCache(str(tmp_path)).get_or_compute("c", "stab", compute(None)), stab.numpy())
