"""Mel filterbank construction (Slaney convention).

Reproduces ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` with its
defaults (htk=False, norm='slaney') — the filterbank the reference builds in
futils/audio.py:98-103 — without depending on librosa. The filterbank is a
static [n_mels, n_fft//2+1] matrix computed once in numpy, so the mel
projection is a single matmul. (A copy of s2v_tpu/audio/filters.py: the
port imports nothing of the JAX package.)
"""

from __future__ import annotations

import functools

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank, Slaney-normalized."""
    if fmax > sample_rate / 2:
        raise ValueError(f"fmax {fmax} is above Nyquist ({sample_rate / 2})")
    n_freq = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: equal-area triangles.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)
