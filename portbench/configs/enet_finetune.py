"""ENet fine-tuning as the ``train`` command runs it (sizes in
``enet_finetune.json``): the weights, the program's side (``s2v_torch.cli``
``train_inputs``: ``load_models`` on the checkpoint directory, Steps 1-3
on the clip and ``build_enet_batches``; then ``make_enet_finetune_step``
with ReconNet's identity term and the VGG16 perceptual term) and the plain
reference's side (``portbench.reference.train.finetune_enet``), in float32
without TF32.

The trained networks (ENet with its LNet, ReconNet-R50, VGG16 features
0-22) are the reference classes' own initialisation, drawn on the card
from ``--seed`` and written as the train command's files each run. The
Steps 1-3 networks (S3FD, 2DFAN4, DNet) come from the configuration's
``weight_seed``, written once per checkout: S3FD and FAN are drawn first,
as ``vrt_default`` draws them from the same seed, so they are its networks
(whose random landmarks give a crop inside the frame on every clip the
benchmark has drawn; another seed's FAN gave an empty FFHQ crop). S3FD's
stride-4 class and box heads read their biases alone, so that the face it
finds is the frame's centre whatever the random trunk says
(``vrt_default``'s heads).
"""

from __future__ import annotations

import contextlib
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

DRIVER = "enet_steps"
STEPS_FILES = ("s3fd.pth", "2DFAN4.pth", "DNet.pt", "BFM", "expression.mat")
# the slim clip: 8 frames and 0.4 s of speech (7 mel chunks), batches of 2, 2, 2 and 1
SLIM_TRAFFIC = dict(clip_frames=8, speech_seconds=0.4)


def slim_sizes() -> dict:
    """The configuration at slim widths for the CPU tests: ENet, ReconNet
    and DNet narrow, 96^2 frames in batches of 2 (VGG16, S3FD and FAN keep
    the widths their loaders fix); ``SLIM_TRAFFIC`` is the clip to go with
    them. The identity term's weight is 10, not 0.1: the slim ReconNet's
    coefficients of the prediction and the target differ by 1e-6 of the
    loss, and at 0.1 the term moves the first gradient by 1e-6, inside the
    CPU's own rounding of the comparison, so that leaving it out would not
    show."""
    sizes = json.loads(Path(__file__).with_suffix(".json").read_text())
    sizes["enet"] = dict(num_style_feat=64, lnet_res_blocks=2, channel_multiplier=0.25,
                         narrow=0.25, lnet_base_nc=8, lnet_max_nc=32)
    sizes["recon"] = dict(layers=[1, 1, 1, 1], base_planes=8)
    sizes["dnet"] = dict(descriptor_nc=16, warp_base_nc=8, edit_base_nc=8, max_nc=32)
    sizes.update(batch=2, frame_size=96, weight_seed=7, id_weight=10.0)
    return sizes


@contextlib.contextmanager
def _seeded(torch, seed: int, device):
    """Draws inside from ``seed``; the global generators as they were after."""
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(int(seed) % (2 ** 63))
        yield


def ensure_steps_weights(torch, sizes: dict, cache_dir: Path, device) -> str:
    """The Steps 1-3 networks' files (S3FD, FAN, DNet, the lm3d and the
    expression basis) under ``cache_dir``, written there once (a
    ``complete`` marker is written last)."""
    from portbench.configs.vrt_default import LM3D
    from portbench.core.synth import write_checkpoint_dir
    from portbench.reference.models.dnet import DNet
    from portbench.reference.models.fan import FAN
    from portbench.reference.models.s3fd import S3FD

    directory = Path(cache_dir) / f"{sizes['name']}-steps-{sizes['weight_seed']}"
    if (directory / "complete").is_file():
        return str(directory)
    with _seeded(torch, sizes["weight_seed"], device), torch.device(device):
        nets = dict(s3fd=S3FD(), fan=FAN(num_modules=4), dnet=DNet(**sizes.get("dnet", {})))
    _s3fd_heads(torch, nets["s3fd"], sizes["heads"], sizes["frame_size"])
    write_checkpoint_dir(torch, str(directory), nets, LM3D, np.zeros(64, np.float32))
    (directory / "complete").write_text("ok\n")
    os.sync()  # the files' writeback belongs to this set-up, not to a window
    return str(directory)


def _s3fd_heads(torch, s3fd, heads: dict, frame_size: int) -> None:
    """S3FD's stride-4 class and box heads read their biases alone: every
    anchor of that map ties, the first wins, and its box sits at the frame's
    centre (``vrt_default._with_heads``' S3FD part)."""
    import math

    centre = frame_size / 2.0
    with torch.no_grad():
        conf, loc = s3fd.conv3_3_norm_mbox_conf, s3fd.conv3_3_norm_mbox_loc
        conf.weight.zero_()
        conf.bias[3] += heads["s3fd_face_bias"]
        box = heads["s3fd_box_share"] * frame_size
        loc.weight.zero_()
        loc.bias.copy_(torch.tensor([(centre - 2.0) / 1.6] * 2 + [math.log(box / 16.0) / 0.2] * 2))


def reference_networks(torch, sizes: dict, device) -> dict:
    """ENet, ReconNet and VGG16 features of the reference at the
    configuration's widths, built on ``device``."""
    from portbench.reference.models.enet import ENet
    from portbench.reference.models.resnet import ReconNet
    from portbench.reference.models.vgg import VGG16Features

    with torch.device(device):
        return dict(enet=ENet(**sizes["enet"]), recon=ReconNet(**sizes["recon"]),
                    vgg=VGG16Features())


def make_weights(torch, sizes: dict, seed: int, device) -> Dict[str, dict]:
    """The trained networks' state_dicts, drawn on ``device`` from ``seed``."""
    with _seeded(torch, seed, device):
        nets = reference_networks(torch, sizes, device)
    return {k: v.state_dict() for k, v in nets.items()}


def write_checkpoints(torch, weights: dict, steps_dir: str, directory: str) -> str:
    """The ``train`` command's checkpoint directory: the Steps 1-3 files
    linked from ``steps_dir``, ENet.pth and LNet.pth (under
    ``state_dict``), face3d_pretrain_epoch_20.pth (under ``net_recon``) and
    the torchvision-layout vgg16.pth written from ``weights``."""
    os.makedirs(directory, exist_ok=True)
    for name in STEPS_FILES:
        os.symlink(os.path.abspath(os.path.join(steps_dir, name)), os.path.join(directory, name))

    def save(sd, name, key=None):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(sd if key is None else {key: sd}, os.path.join(directory, name))

    enet = weights["enet"]
    save(enet, "ENet.pth", "state_dict")
    save({k[len("low_res."):]: v for k, v in enet.items() if k.startswith("low_res.")},
         "LNet.pth", "state_dict")
    save(weights["recon"], "face3d_pretrain_epoch_20.pth", "net_recon")
    save(weights["vgg"], "vgg16.pth")
    return directory


def train_config(sizes: dict, clip: str, wav: str, checkpoint_dir: str, tmp_dir: str):
    """The port's ``PipelineConfig`` of the ``train`` command on this clip
    and speech, with the configuration's training sizes."""
    from s2v_torch.utils.config import PipelineConfig, override

    if tuple(sizes["betas"]) != (0.9, 0.999) or sizes["eps"] != 1e-8:
        raise ValueError("the fine-tune's Adam is torch's default: betas (0.9, 0.999), eps 1e-8")
    return override(PipelineConfig(), {
        "infer.face": clip, "infer.audio": wav, "infer.checkpoint_dir": checkpoint_dir,
        "infer.tmp_dir": tmp_dir, "infer.fps": sizes["fps"], "model.img_size": sizes["img_size"],
        "train.batch_size": sizes["batch"], "train.lr": sizes["lr"],
        "train.l1_weight": sizes["l1_weight"], "train.perceptual_weight":
        sizes["perceptual_weight"], "train.id_weight": sizes["id_weight"]})


def program_functions() -> tuple:
    """The program's entry points this configuration drives, looked up
    before anything is built, so that a program without them fails at
    once: ``cli.train_inputs``, ``finetune_enet.device_batches``,
    ``make_enet_finetune_step`` and ``make_id_embed_fn``."""
    from s2v_torch.cli import train_inputs
    from s2v_torch.train.finetune_enet import (device_batches, make_enet_finetune_step,
                                               make_id_embed_fn)

    return train_inputs, device_batches, make_enet_finetune_step, make_id_embed_fn


def program(torch, cfg, device):
    """The ``train`` command's inputs and step: ``cli.train_inputs`` (the
    models from the checkpoint directory, Steps 1-3 and
    ``build_enet_batches``), then ``make_enet_finetune_step`` with
    ``make_id_embed_fn(recon)`` and the VGG16 features. Returns (state,
    step_fn, the batches on the device)."""
    train_inputs, device_batches, make_step, make_id_embed_fn = program_functions()
    pipe, batches, vgg = train_inputs(cfg, device)
    if vgg is None or pipe.models.recon is None:
        raise RuntimeError("the checkpoint directory lacks vgg16.pth or ReconNet")
    state, step = make_step(pipe.models.enet, cfg.train, device,
                            id_embed_fn=make_id_embed_fn(pipe.models.recon), vgg=vgg)
    return state, step, device_batches(batches, pipe.device)


def reference_step(torch, sizes: dict, weights: dict, device):
    """The reference's ``make_step`` over the same weights: (the trainable
    leaves, the step)."""
    from portbench.reference.train.finetune_enet import make_step

    nets = reference_networks(torch, sizes, device)
    for k, net in nets.items():
        net.load_state_dict(weights[k], strict=True)
    return make_step(nets["enet"], nets["recon"], nets["vgg"], sizes["lr"], sizes["l1_weight"],
                     sizes["perceptual_weight"], sizes["id_weight"], device)


def step_flops(torch, sizes: dict, batch: int) -> int:
    """FLOPs of one reference step on ``batch`` frames, on the meta device:
    ENet's forward, VGG16 on the prediction and the target,
    ReconNet on both, and the backward from the loss to the style convs
    (the FFTs and Adam's elementwise work are not counted)."""
    from portbench.core.flops import count
    from portbench.reference.train.finetune_enet import loss_terms, style_conv_names

    nets = reference_networks(torch, sizes, "meta")
    for net in nets.values():
        net.eval().requires_grad_(False)
    params = dict(nets["enet"].named_parameters())
    for k in style_conv_names(nets["enet"]):
        params[k].requires_grad_(True)
    n, s = batch, sizes["img_size"]
    batch = dict(mel=torch.empty(n, 1, 80, 16, device="meta"),
                 face=torch.empty(n, 6, s, s, device="meta"),
                 ref=torch.empty(n, 3, s, s, device="meta"),
                 target=torch.empty(n, 3, s, s, device="meta"))

    def step():
        *_, loss = loss_terms(nets["enet"], nets["recon"], nets["vgg"], batch,
                              sizes["l1_weight"], sizes["perceptual_weight"], sizes["id_weight"])
        loss.backward()

    return count(torch, step)
