"""Dataset-preparation tooling (reference: preprocessing/{video2audio,
audio2codes,normalized_text}.py; s2v_tpu/prep/tools.py).

- ``video_to_audio``: mp4 -> wav (the reference uses moviepy; here an
  ffmpeg binary, or a clear error without one).
- ``normalize_text``: MFA text cleanup — strip the speaker header before
  the first ':' and keep only the first line (normalized_text.py:12-20).
- ``audio_to_codes``: per-video-frame EnCodec discrete codes with the
  reference's windowing (audio2codes.py:34-56: 0.2 s window starting at each
  frame, (1, 32, 15) codes at bandwidth 24). The caller passes the codec:
  any object with ``encode_numpy(chunk, sr)``, such as
  ``s2v_torch.models.encodec.EncodecCodec``, which runs on the card unless
  it is built with ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def video_to_audio(path: str, outdir: Optional[str] = None) -> str:
    """mp4 -> 16-bit wav next to the video (video2audio.py:13-19)."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "video_to_audio requires an ffmpeg binary (the reference uses "
            "moviepy, which also wraps ffmpeg)."
        )
    out = (os.path.join(outdir, os.path.basename(path))
           if outdir else path)[:-3] + "wav"
    subprocess.run(
        [ffmpeg, "-loglevel", "error", "-y", "-i", path, "-vn", out],
        check=True,
    )
    return out


def remove_header(text: str) -> str:
    """normalized_text.py:12-13."""
    return "".join(text.split(":")[1:])


def remove_footer(text: str) -> str:
    """normalized_text.py:15-20."""
    lines = text.splitlines()
    if not lines:
        raise ValueError("empty text after header removal")
    return "".join(lines[0])


def normalize_text(text: str) -> str:
    return remove_footer(remove_header(text))


def normalize_text_file(path: str, outdir: Optional[str] = None) -> str:
    with open(path, "r", encoding="utf-8") as f:
        text = normalize_text(f.read())
    out = os.path.join(outdir, os.path.basename(path)) if outdir else path
    with open(out, "w") as f:
        f.write(text)
    return out


def frame_windows(wav: np.ndarray, sr: int, n_frames: int, fps: float,
                  window_s: float = 0.2) -> np.ndarray:
    """audio2codes.py:41-48: zero-pad 0.1 s both sides, then one
    ``window_s`` chunk starting at each video frame. [N, window]."""
    nr = int(window_s / 2 * sr)
    wav = np.pad(wav, (nr, nr))
    idx_multiplier = int(1.0 / fps * sr)
    out = np.zeros((n_frames, 2 * nr), wav.dtype)
    for i in range(n_frames):
        chunk = wav[i * idx_multiplier : i * idx_multiplier + 2 * nr]
        out[i, : len(chunk)] = chunk
    return out


def audio_to_codes(wav: np.ndarray, sr: int, n_frames: int, fps: float,
                   codec=None) -> np.ndarray:
    """Per-frame discrete codes [N, n_q, T] (audio2codes.py:34-56)."""
    if codec is None:
        raise RuntimeError(
            "audio_to_codes needs a codec: pass s2v_torch.models.encodec."
            "EncodecCodec(model), which runs on the CUDA card, or "
            "EncodecCodec(model, device='cpu') to run on the CPU on purpose."
        )
    windows = frame_windows(wav, sr, n_frames, fps)
    return np.stack([codec_encode(codec, chunk, sr) for chunk in windows])


def codec_encode(codec, chunk: np.ndarray, sr: int) -> np.ndarray:
    """Encode one mono window with a codec's ``encode_numpy`` hook."""
    return np.asarray(codec.encode_numpy(chunk, sr))
