"""Audio IO (reference: futils/audio.py:9-10 load_wav via librosa; a copy
of s2v_tpu/io/audio_io.py, sample for sample).

librosa is not a dependency; WAV files are read with the stdlib ``wave``
module and resampled with a polyphase filter (scipy), which is librosa's
own default resampler family. Non-WAV containers require an ffmpeg binary
(the reference shells out to ffmpeg the same way, inference.py:200-203).
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from fractions import Fraction

import numpy as np


def _read_wav(path: str):
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wav
    from scipy.signal import resample_poly

    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """Load audio as mono float32 [-1, 1] at the requested rate."""
    if path.lower().endswith(".wav"):
        wav, sr_in = _read_wav(path)
        return resample(wav, sr_in, sr)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and no ffmpeg binary on "
            "PATH. Convert to 16 kHz WAV first."
        )
    out = subprocess.run(
        [ffmpeg, "-loglevel", "error", "-i", path, "-f", "f32le", "-ac", "1",
         "-ar", str(sr), "-"],
        capture_output=True, check=True,
    )
    return np.frombuffer(out.stdout, dtype=np.float32)
