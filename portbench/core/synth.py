"""The benchmark's inputs, made from a seed: talking-head clips, speech,
training faces and their degradation, and the reference-format weight
files of a configuration. Frozen copies of ``chip_smoke.py``'s makers
(``clip_inputs``, ``synthetic_faces``, ``write_wav``) and of
``s2v_torch.cli.write_checkpoint_dir``'s format, drawn here with
``torch.Generator``s on the card instead of numpy on the host.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Dict

import numpy as np

SAMPLE_RATE = 16000


def stream(seed: int, *tags: int) -> int:
    """A seed of its own for each stream of draws (weights, clips, speech,
    samples), from the run's seed and the stream's tags."""
    return int(np.random.SeedSequence([int(seed) % (2 ** 63), *tags]).generate_state(
        2, np.uint64)[0] % (2 ** 63))


def generator(torch, seed: int, device) -> "torch.Generator":
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def clip_frames(torch, n: int, h: int, w: int, gen, device) -> np.ndarray:
    """[n, h, w, 3] uint8: a colour gradient under Gaussian noise of 20 gray
    levels (``clip_inputs``), shifted by an offset drawn per clip, so that
    clips of different seeds differ in every pixel."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    base = torch.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
    shift = (torch.rand(3, generator=gen, device=device) - 0.5) * 40.0
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 20.0
    return torch.clamp(base[None] + shift + noise, 0, 255).to(torch.uint8).cpu().numpy()


def speech(torch, seconds: float, gen) -> np.ndarray:
    """A voiced-like track of ``seconds`` at 16 kHz (``clip_inputs``'s
    amplitude-modulated tone with a little noise), its pitch, syllable rate
    and phase drawn from ``gen``; float32 in [-1, 1]."""
    u = torch.rand(3, generator=gen, device=gen.device).cpu().numpy().astype(np.float64)
    f0, rate, phase = 120.0 + 140.0 * u[0], 2.0 + 3.0 * u[1], 2 * math.pi * u[2]
    t = np.arange(int(round(seconds * SAMPLE_RATE))) / SAMPLE_RATE
    noise = torch.randn(len(t), generator=gen, device=gen.device).cpu().numpy()
    return (0.5 * np.sin(2 * np.pi * f0 * t + phase)
            * (1 + 0.5 * np.sin(2 * np.pi * rate * t)) + 0.01 * noise).astype(np.float32)


def write_wav(path: str, wav: np.ndarray) -> None:
    pcm = (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def faces(torch, n: int, size: int, gen, device) -> "torch.Tensor":
    """[n, size, size, 3] in [-1, 1]: ``synthetic_faces``' skin-toned
    ellipse with dark eyes and a red mouth on a gradient background, its
    centre and tone jittered per image, under noise of 4 gray levels."""
    yy, xx = torch.meshgrid(*(torch.arange(size, device=device, dtype=torch.float32) + 0.5,) * 2,
                            indexing="ij")
    yy, xx = yy / size, xx / size
    c = 0.5 + (torch.rand((n, 2, 1, 1), generator=gen, device=device) - 0.5) * 0.1
    cx, cy = c[:, 0], c[:, 1]
    tone = 150 + 80 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    img = torch.stack([xx * 120 + 60, yy * 100 + 50, (xx + yy) * 60 + 40], -1).expand(
        n, size, size, 3).clone()
    skin = tone * torch.tensor([1.0, 0.8, 0.65], device=device)
    face = (((xx - cx) / 0.32) ** 2 + ((yy - cy) / 0.42) ** 2 < 1)[..., None]
    img = torch.where(face, skin.expand_as(img), img)
    for ex in (-0.12, 0.12):
        eye = (((xx - cx - ex) / 0.06) ** 2 + ((yy - cy + 0.1) / 0.03) ** 2 < 1)[..., None]
        img = torch.where(eye, torch.full_like(img, 40.0), img)
    mouth = (((xx - cx) / 0.14) ** 2 + ((yy - cy - 0.2) / 0.04) ** 2 < 1)[..., None]
    img = torch.where(mouth, torch.tensor([150.0, 50.0, 60.0], device=device).expand_as(img), img)
    img = img + torch.randn(img.shape, generator=gen, device=device) * 4
    return torch.clamp(img, 0, 255).round() / 127.5 - 1.0


def degrade(torch, hq: "torch.Tensor", gen, scale: int = 4) -> "torch.Tensor":
    """The plain degradation of the training pool: a Gaussian blur (sigma
    0.2-3 px, per image), down by ``scale`` (area), Gaussian noise (0-10
    gray levels), up by ``scale`` (bilinear); hq and the result [n, H, W, 3]
    in [-1, 1]."""
    import torch.nn.functional as F

    n, h, w, _ = hq.shape
    dev = hq.device
    x = hq.permute(0, 3, 1, 2)
    sigma = 0.2 + 2.8 * torch.rand(n, generator=gen, device=dev)
    r = torch.arange(-10, 11, device=dev, dtype=torch.float32)
    k = torch.exp(-0.5 * (r[None] / sigma[:, None]) ** 2)
    k = k / k.sum(1, keepdim=True)                                   # [n, 21]
    x = F.pad(x, (10, 10, 10, 10), mode="reflect")
    x = x.reshape(1, n * 3, h + 20, w + 20)
    kh = k.repeat_interleave(3, 0)
    x = F.conv2d(x, kh[:, None, :, None], groups=n * 3)
    x = F.conv2d(x, kh[:, None, None, :], groups=n * 3).reshape(n, 3, h, w)
    x = F.avg_pool2d(x, scale)
    level = 10.0 / 127.5 * torch.rand((n, 1, 1, 1), generator=gen, device=dev)
    x = x + torch.randn(x.shape, generator=gen, device=dev) * level
    x = F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)
    return torch.clamp(x, -1.0, 1.0).permute(0, 2, 3, 1).contiguous()


# s2v_torch.cli.CHECKPOINT_FILES' names and keys for the files written here
CHECKPOINT_FILES = {
    "s3fd": ("s3fd.pth", None), "fan": ("2DFAN4.pth", None),
    "recon": ("face3d_pretrain_epoch_20.pth", "net_recon"), "dnet": ("DNet.pt", "net_G_ema"),
    "enet": ("ENet.pth", "state_dict"), "retinaface": ("RetinaFace-R50.pth", None),
    "parsenet": ("ParseNet-latest.pth", None), "gfpgan": ("GFPGANv1.3.pth", "params_ema"),
    "gpen512": ("GPEN-BFR-512.pth", None), "gpen2048": ("GPEN-BFR-2048.pth", None),
    "srmodel": ("realesrnet_x2.pth", "params_ema"),
}


def write_checkpoint_dir(torch, directory: str, modules: Dict[str, "torch.nn.Module"],
                         lm3d: np.ndarray, expression: np.ndarray) -> None:
    """``modules`` (names of ``CHECKPOINT_FILES``) saved as the reference's
    files in ``directory``: ENet's LNet also as LNet.pth, ``lm3d`` [5, 3]
    at the 68-point rows of BFM/similarity_Lm3D_all.mat that the loader
    reads, ``expression`` [64] as expression.mat."""
    from scipy.io import savemat

    os.makedirs(directory, exist_ok=True)

    def save(sd, name, key):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(sd if key is None else {key: sd}, os.path.join(directory, name))

    for name, module in modules.items():
        sd = module.state_dict()
        save(sd, *CHECKPOINT_FILES[name])
        if name == "enet":
            save({k[len("low_res."):]: v for k, v in sd.items() if k.startswith("low_res.")},
                 "LNet.pth", "state_dict")
    lm = np.zeros((68, 3))
    for rows, point in zip(((36, 39), (42, 45), (30,), (48,), (54,)), lm3d):
        lm[list(rows)] = point
    os.makedirs(os.path.join(directory, "BFM"), exist_ok=True)
    savemat(os.path.join(directory, "BFM", "similarity_Lm3D_all.mat"), {"lm": lm})
    savemat(os.path.join(directory, "expression.mat"),
            {"expression_center": np.asarray(expression, np.float32)[None]})
