"""EnCodec 24 kHz neural audio codec (reference capability:
third_part/emb/qnt.py encode/decode + preprocessing/audio2codes.py — wav to
(n_q, T) discrete codes at 75 Hz via Meta's EnCodec 24 kHz model;
s2v_tpu/models/encodec.py), NCL.

- SEANet encoder: causal Conv1d(1->32, k7), four blocks of [residual unit
  (k3 + k1 convs, ELU) -> ELU -> strided down conv k=2r] with ratios
  (2, 4, 5, 8) and doubling channels, a 2-layer LSTM with a skip, and a
  final k7 conv to the 128-d latent. Frame rate 24000 / 320 = 75 Hz.
- Residual vector quantizer: n_q codebooks of 1024 entries quantizing the
  residual in sequence (codes = argmin ||r - c||, the first of equal
  distances).
- SEANet decoder (mirror, transposed convs with the causal right-trim) for
  ``decode_codes``.

Module names are Meta's checkpoint keys (``encoder.model.{i}.conv.conv``,
``...convtr.convtr``, ``...block.{1,3}``, ``...shortcut``, ``...lstm``,
``quantizer.vq.layers.{q}._codebook.embed``) with plain conv weights:
``reference_state_dict`` folds the weight norm of either public layout
(Meta's ``encodec`` package or transformers') so that both load strictly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s2v_torch.device import full_f32, resolve_device

RATIOS = (8, 5, 4, 2)  # encoder downsampling, applied reversed
HOP = int(np.prod(RATIOS))  # 320
# the decoder's transposed convs sit at these indices of ``decoder.model``
_UPSAMPLES = tuple(3 * (i + 1) for i in range(len(RATIOS)))
_CODEBOOK_EMA = ("._codebook.inited", "._codebook.cluster_size", "._codebook.embed_avg")


def causal_pad(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """EnCodec causal padding of [B, C, T]: (k-1)*d - (s-1) samples on the
    left plus the right padding needed to cover the last frame
    (encodec.modules.conv), reflected as SEANet's pad_mode is. An input no
    longer than the padding is first zero-extended on the right, as
    s2v_tpu's is, since a reflection must be shorter than its input."""
    eff_k = (kernel - 1) * dilation + 1
    pad_total = eff_k - stride
    length = x.shape[-1]
    n_frames = (length - eff_k + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + eff_k - pad_total
    extra = max(ideal - length, 0)
    if length <= max(pad_total, extra):
        x = F.pad(x, (0, max(pad_total, extra) - length + 1))
    return F.pad(x, (pad_total, extra), mode="reflect")


class NormConv1d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride, dilation=dilation)


class SConv1d(nn.Module):
    """Causally padded Conv1d (encodec.modules.conv.SConv1d)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = NormConv1d(cin, cout, kernel, stride, dilation)

    def forward(self, x):
        c = self.conv.conv
        return c(causal_pad(x, c.kernel_size[0], c.stride[0], c.dilation[0]))


class NormConvTranspose1d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.convtr = nn.ConvTranspose1d(cin, cout, kernel, stride)


class SConvTranspose1d(nn.Module):
    """Transposed Conv1d trimmed on the right to ``T * stride`` samples
    (causal, trim_right_ratio 1)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.convtr = NormConvTranspose1d(cin, cout, kernel, stride)

    def forward(self, x):
        c = self.convtr.convtr
        return c(x)[..., :x.shape[-1] * c.stride[0]]


class SEANetResnetBlock(nn.Module):
    """ELU -> k3 conv to dim / 2 -> ELU -> k1 conv, plus a k1 shortcut."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(nn.ELU(), SConv1d(dim, dim // 2, 3), nn.ELU(),
                                   SConv1d(dim // 2, dim, 1))
        self.shortcut = SConv1d(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class SLSTM(nn.Module):
    """Stacked LSTM over time with a skip connection (encodec's SLSTM);
    torch's gates i, f, g, o are s2v_tpu's."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers)

    def forward(self, x):  # [B, C, T]
        x = x.permute(2, 0, 1)
        y, _ = self.lstm(x)
        return (y + x).permute(1, 2, 0)


class SEANetEncoder(nn.Module):
    def __init__(self, n_filters: int = 32, dimension: int = 128, lstm_layers: int = 2):
        super().__init__()
        mult = 1
        layers = [SConv1d(1, n_filters, 7)]
        for ratio in reversed(RATIOS):
            layers += [SEANetResnetBlock(mult * n_filters), nn.ELU(),
                       SConv1d(mult * n_filters, mult * n_filters * 2, ratio * 2, stride=ratio)]
            mult *= 2
        layers += [SLSTM(mult * n_filters, lstm_layers), nn.ELU(),
                   SConv1d(mult * n_filters, dimension, 7)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):  # [B, 1, T] -> [B, D, ceil(T / 320)]
        return self.model(x)


class SEANetDecoder(nn.Module):
    def __init__(self, n_filters: int = 32, dimension: int = 128, lstm_layers: int = 2):
        super().__init__()
        mult = 2 ** len(RATIOS)
        layers = [SConv1d(dimension, mult * n_filters, 7), SLSTM(mult * n_filters, lstm_layers)]
        for ratio in RATIOS:
            layers += [nn.ELU(),
                       SConvTranspose1d(mult * n_filters, mult * n_filters // 2, ratio * 2, ratio),
                       SEANetResnetBlock(mult * n_filters // 2)]
            mult //= 2
        layers += [nn.ELU(), SConv1d(n_filters, 1, 7)]
        self.model = nn.Sequential(*layers)

    def forward(self, z):  # [B, D, T] -> [B, 1, T * 320]
        return self.model(z)


class EuclideanCodebook(nn.Module):
    def __init__(self, codebook_size: int, dimension: int):
        super().__init__()
        self.register_buffer("embed", torch.randn(codebook_size, dimension))


class VectorQuantization(nn.Module):
    def __init__(self, codebook_size: int, dimension: int):
        super().__init__()
        self._codebook = EuclideanCodebook(codebook_size, dimension)


class _Layers(nn.Module):
    def __init__(self, n_q: int, codebook_size: int, dimension: int):
        super().__init__()
        self.layers = nn.ModuleList(VectorQuantization(codebook_size, dimension)
                                    for _ in range(n_q))


class ResidualVQ(nn.Module):
    """Residual vector quantizer (encodec.quantization.ResidualVectorQuantizer);
    the codebooks are buffers, N(0, 1) until loaded."""

    def __init__(self, n_q: int = 32, codebook_size: int = 1024, dimension: int = 128):
        super().__init__()
        self.n_q = n_q
        self.vq = _Layers(n_q, codebook_size, dimension)

    def codebook(self, q: int) -> torch.Tensor:
        return self.vq.layers[q]._codebook.embed

    def forward(self, z, n_q: Optional[int] = None):
        """z [B, D, T] -> (quantized [B, D, T], codes [B, n_q, T])."""
        residual = z.transpose(1, 2)
        quantized = torch.zeros_like(residual)
        codes = []
        for q in range(n_q or self.n_q):
            cb = self.codebook(q)  # [K, D]
            d2 = (torch.sum(residual * residual, -1, keepdim=True) - 2.0 * residual @ cb.T
                  + torch.sum(cb * cb, -1)[None, None, :])
            idx = torch.argmin(d2, dim=-1)  # [B, T]
            sel = cb[idx]
            quantized = quantized + sel
            residual = residual - sel
            codes.append(idx)
        return quantized.transpose(1, 2), torch.stack(codes, dim=1)


class EncodecModel(nn.Module):
    """encode(): wav [B, 1, T] at 24 kHz -> codes [B, n_q, ceil(T / 320)].
    Runs in full f32 without TF32, so codes keep f32 distances."""

    sample_rate = 24000
    channels = 1

    def __init__(self, n_q: int = 32):
        super().__init__()
        self.n_q = n_q
        self.encoder = SEANetEncoder()
        self.decoder = SEANetDecoder()
        self.quantizer = ResidualVQ(n_q=n_q)

    def encode(self, wav, n_q: Optional[int] = None):
        with full_f32():
            return self.quantizer(self.encoder(wav), n_q=n_q)[1]

    def decode_codes(self, codes):
        """codes [B, n_q, T] -> wav [B, 1, T * 320]."""
        with full_f32():
            z = sum(self.quantizer.codebook(q)[codes[:, q]] for q in range(codes.shape[1]))
            return self.decoder(z.transpose(1, 2))

    def forward(self, wav):
        with full_f32():
            zq, codes = self.quantizer(self.encoder(wav))
            return self.decoder(zq), codes


def frame_codes_per_video_frame(codes) -> Tuple[int, int]:
    """audio2codes.py windows 0.2 s -> 15 code frames at 75 Hz."""
    return codes.shape[1], codes.shape[2]


def reference_state_dict(sd) -> Dict[str, torch.Tensor]:
    """An EnCodec 24 kHz checkpoint's state_dict in either public layout ->
    this module's: Meta's ``encodec`` keys (``encoder.model.{i}.conv.conv
    .weight_g``/``_v``, ``...convtr.convtr...``,
    ``quantizer.vq.layers.{q}._codebook.embed``) or transformers'
    (``encoder.layers.{i}.conv.parametrizations.weight.original0``/``1``,
    ``quantizer.layers.{q}.codebook.embed``). Weight norm is folded
    (``g * v / ||v||`` over all but the first axis, as torch's weight_norm
    with dim 0 and s2v_tpu's ``convert_encodec`` compute it); the
    codebooks' k-means and EMA bookkeeping (``inited``, ``cluster_size``,
    ``embed_avg``), which encoding never reads, is dropped."""
    hf = any(".parametrizations." in k or k.startswith(("encoder.layers.", "decoder.layers."))
             for k in sd)
    out = {}
    for k, v in sd.items():
        if hf:
            k = (k.replace("encoder.layers.", "encoder.model.")
                 .replace("decoder.layers.", "decoder.model.")
                 .replace("quantizer.layers.", "quantizer.vq.layers.")
                 .replace(".codebook.", "._codebook.")
                 .replace(".parametrizations.weight.original0", ".weight_g")
                 .replace(".parametrizations.weight.original1", ".weight_v"))
            if ".conv." in k:  # transformers' wrapper holds the conv itself
                parts = k.split(".")
                up = parts[0] == "decoder" and int(parts[2]) in _UPSAMPLES and parts[3] == "conv"
                k = k.replace(".conv.", ".convtr.convtr." if up else ".conv.conv.", 1)
        if not k.endswith(_CODEBOOK_EMA):
            out[k] = torch.as_tensor(v)
    for k in [k for k in out if k.endswith(".weight_g")]:
        base = k[:-len("_g")]
        g, v = out.pop(k), out.pop(base + "_v")
        out[base] = g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
    return out


class EncodecCodec:
    """``s2v_torch.prep.tools.codec_encode``'s protocol adapter (the
    ``encode_numpy`` hook, s2v_tpu's ``JaxEncodecCodec``): an
    ``EncodecModel`` on the card, so ``audio_to_codes(..., codec=
    EncodecCodec(model))`` needs no ``encodec`` package. ``device`` defaults
    to the card and raises without one; pass ``"cpu"`` to run on the CPU on
    purpose."""

    sample_rate = 24000
    channels = 1

    def __init__(self, model: EncodecModel, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def encode_numpy(self, chunk: np.ndarray, sr: int) -> np.ndarray:
        """mono [T] at sr -> codes [n_q, T'] at 75 Hz."""
        if sr != self.sample_rate:
            from s2v_torch.io.audio_io import resample

            chunk = resample(np.asarray(chunk, np.float32), sr, self.sample_rate)
        wav = torch.as_tensor(np.asarray(chunk, np.float32), device=self.device)[None, None]
        return self.model.encode(wav)[0].cpu().numpy()
