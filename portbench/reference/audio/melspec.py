"""Mel-spectrogram frontend (reference: futils/audio.py:20-123), librosa
0.9.2 conventions:

  wav -> preemphasis(0.97) -> STFT(n_fft=800, hop=200, win=800, periodic
  hann, center=True, reflect padding) -> |.| -> mel(80, slaney) -> 20*log10
  -> -ref_level_db -> symmetric +-4 normalise

The STFT is a windowed projection of the frames onto the real-DFT basis
(n_fft = 800 is not a power of two), one matmul, followed by the mel
projection; all in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.audio.filters import hann_window, mel_filterbank
from portbench.reference.utils.config import AudioConfig


def preemphasis(wav: torch.Tensor, k: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - k*x[n-1], y[0] = x[0]."""
    return torch.cat([wav[:1], wav[1:] - k * wav[:-1]])


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_size: int) -> np.ndarray:
    """[n_fft, 2*(n_fft//2+1)] windowed real-DFT basis (cos | -sin)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    window = hann_window(win_size).astype(np.float64)
    if win_size < n_fft:
        pad = (n_fft - win_size) // 2
        window = np.pad(window, (pad, n_fft - win_size - pad))
    return (basis * window[:, None]).astype(np.float32)


def stft_magnitude(y: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """|STFT(y)| as [n_frames, n_fft//2+1]."""
    y = F.pad(y[None, None], (cfg.n_fft // 2, cfg.n_fft // 2), mode="reflect")[0, 0]
    frames = y.unfold(0, cfg.n_fft, cfg.hop_size)  # [n_frames, n_fft]
    basis = torch.from_numpy(_dft_basis(cfg.n_fft, cfg.win_size)).to(y.device)
    proj = frames @ basis
    re, im = proj[:, :cfg.n_freq], proj[:, cfg.n_freq:]
    return torch.sqrt(re * re + im * im)


def melspectrogram(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """wav [T] float in [-1, 1] -> mel [num_mels, n_frames] in [-4, 4], on
    wav's device."""
    if wav.dim() != 1:
        raise ValueError(f"melspectrogram expects a mono [T] waveform, got {tuple(wav.shape)}")
    wav = wav.float()
    if cfg.preemphasize:
        wav = preemphasis(wav, cfg.preemphasis)
    mag = stft_magnitude(wav, cfg)
    mel_basis = torch.from_numpy(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)).to(wav.device)
    mel = mag @ mel_basis.t()
    min_level = float(np.exp(cfg.min_level_db / 20.0 * np.log(10.0)))
    s = 20.0 * torch.log10(torch.clamp(mel, min=min_level)) - cfg.ref_level_db
    if cfg.signal_normalization:
        scaled = (s - cfg.min_level_db) / (-cfg.min_level_db)
        if cfg.symmetric_mels:
            s = 2.0 * cfg.max_abs_value * scaled - cfg.max_abs_value
            lo, hi = -cfg.max_abs_value, cfg.max_abs_value
        else:
            s = cfg.max_abs_value * scaled
            lo, hi = 0.0, cfg.max_abs_value
        if cfg.allow_clipping_in_normalization:
            s = torch.clamp(s, lo, hi)
    return s.t()


def mel_chunk_starts(n_mel_frames: int, n_video_frames: int, fps: float,
                     mel_step_size: int = 16) -> np.ndarray:
    """Start of the 80x16 conditioning window of each video frame: stride
    80/fps mel frames; windows past the end clamp to the last full one."""
    mult = 80.0 / fps
    starts = []
    for i in range(n_video_frames):
        start = int(i * mult)
        if start + mel_step_size > n_mel_frames:
            start = n_mel_frames - mel_step_size
        starts.append(max(start, 0))
    return np.asarray(starts, dtype=np.int64)


def num_mel_chunks(n_mel_frames: int, fps: float, mel_step_size: int = 16) -> int:
    """Number of chunks the reference loop yields (inference.py:209-216)."""
    mult = 80.0 / fps
    i = 0
    while int(i * mult) + mel_step_size <= n_mel_frames:
        i += 1
    return i + 1


def mel_chunks_for_frames(mel: torch.Tensor, n_video_frames: int, fps: float,
                          mel_step_size: int = 16) -> torch.Tensor:
    """[num_mels, T] -> [N, num_mels, step] per-frame mel windows."""
    starts = mel_chunk_starts(mel.shape[1], n_video_frames, fps, mel_step_size)
    idx = torch.from_numpy(starts[:, None] + np.arange(mel_step_size)[None, :])
    return mel[:, idx.to(mel.device)].permute(1, 0, 2)
