"""VideoReTalking's default ``infer`` (sizes in ``vrt_default.json``): the
weights this configuration runs, the program's side (the ``infer``
command's ``load_models`` and ``LipSyncPipeline``) and the plain
reference's side (``portbench.reference``, float32 without TF32, or one
precision below what the configuration states, for the control).

Every network keeps its published width. The weights are random, drawn
once per checkout from the configuration's ``weight_seed`` with the
reference's classes on the card, and written as the reference's files
(``core.synth.write_checkpoint_dir``); the program loads them through
``s2v_torch.cli.load_models``, the reference loads them strictly into its
own classes. Random detectors find no face and decide boxes and
landmarks by an argmax over near-equal scores, so ``_with_heads`` sets
the heads that decide (see ``assumed`` in the sizes file): S3FD's stride-4
class and box heads and RetinaFace's level-2 class, box and landmark heads
read their biases alone, so every anchor of those maps ties exactly, the
first wins in the program and in the reference alike whatever the
precision, and its box (and RetinaFace's five points, at the facexlib
template's layout in a square twice the anchor's size) sit at the frame's
centre. FAN's landmarks stay the random network's.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

DRIVER = "infer_requests"

# a synthetic 5-point lm3d (the BFM file is not in the repository), as the
# port's tests and smoke use
LM3D = np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                   [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float64)
ROLES = ("s3fd", "fan", "recon", "dnet", "enet", "retinaface", "parsenet", "gfpgan",
         "gpen512", "gpen2048", "srmodel")
MOUTH_CLASS = 11  # ParseNet's upper lip: 255 in the face and in the mouth colormap


def reference_networks(torch, sizes: dict, device, roles: Sequence[str] = ROLES) -> dict:
    """The reference's classes at the configuration's widths, built on
    ``device`` with their own initialisation."""
    from portbench.reference.models.dnet import DNet
    from portbench.reference.models.enet import ENet
    from portbench.reference.models.fan import FAN
    from portbench.reference.models.gfpgan import GFPGANv1Clean
    from portbench.reference.models.gpen import FullGenerator
    from portbench.reference.models.parsenet import ParseNet
    from portbench.reference.models.resnet import ReconNet
    from portbench.reference.models.retinaface import RetinaFace
    from portbench.reference.models.rrdbnet import RRDBNet
    from portbench.reference.models.s3fd import S3FD

    classes = dict(s3fd=S3FD, fan=FAN, recon=ReconNet, dnet=DNet, enet=ENet,
                   retinaface=RetinaFace, parsenet=ParseNet, gfpgan=GFPGANv1Clean,
                   gpen512=FullGenerator, gpen2048=FullGenerator, srmodel=RRDBNet)
    nets = sizes["networks"]
    with torch.device(device):
        return {r: classes[r](**nets[r]["kwargs"]) for r in roles}


def _with_heads(torch, nets: dict, heads: dict, frame_size: int) -> dict:
    """Set the detectors' deciding heads (the module docstring says why):
    each winning anchor is the first of its map, and its box and points are
    moved from that anchor to the frame's centre by the heads' biases."""
    from portbench.reference.pipeline.restoration import FACEXLIB_TEMPLATE_512

    centre = frame_size / 2.0
    with torch.no_grad():
        s3fd = nets["s3fd"]
        conf, loc = s3fd.conv3_3_norm_mbox_conf, s3fd.conv3_3_norm_mbox_loc
        conf.weight.zero_()
        conf.bias[3] += heads["s3fd_face_bias"]
        # the stride-4 map's first anchor: centre (2, 2), 16 px; decode
        # variances 0.1 (centre) and 0.2 (size)
        box = heads["s3fd_box_share"] * frame_size
        loc.weight.zero_()
        loc.bias.copy_(torch.tensor([(centre - 2.0) / 1.6] * 2 + [math.log(box / 16.0) / 0.2] * 2))
        retina = nets["retinaface"]
        for head in (retina.ClassHead[2], retina.BboxHead[2], retina.LandmarkHead[2]):
            head.conv1x1.weight.zero_()
        retina.ClassHead[2].conv1x1.bias[[1, 3]] += heads["retina_face_bias"]
        retina.ClassHead[2].conv1x1.bias[3] += heads["retina_512_bias"]
        # level 2's first 512-px anchor: centre (16, 16) px; an offset of 1
        # moves a point by 0.1 x 512 px
        shift = (centre - 16.0) / 51.2
        retina.BboxHead[2].conv1x1.bias.copy_(torch.tensor([shift, shift, 0.0, 0.0] * 2))
        offsets = (FACEXLIB_TEMPLATE_512 - 256.0) / 512.0 * heads["retina_span"] / 0.1 + shift
        retina.LandmarkHead[2].conv1x1.bias.copy_(
            torch.from_numpy(np.tile(offsets.reshape(-1), 2)).float())
        nets["parsenet"].out_mask_conv.conv2d.bias[MOUTH_CLASS] += heads["parsenet_mouth_bias"]
    return nets


def ensure_weights(torch, sizes: dict, cache_dir: Path, device) -> str:
    """The weight files of this configuration under ``cache_dir``, written
    there once (a ``complete`` marker is written last)."""
    from portbench.core.synth import write_checkpoint_dir

    directory = Path(cache_dir) / f"{sizes['name']}-{sizes['weight_seed']}"
    if (directory / "complete").is_file():
        return str(directory)
    with torch.random.fork_rng(devices=[torch.device(device)] if torch.device(device).type
                               == "cuda" else []):
        torch.manual_seed(sizes["weight_seed"])
        nets = _with_heads(torch, reference_networks(torch, sizes, device), sizes["heads"],
                           sizes["frame_size"])
    write_checkpoint_dir(torch, str(directory), nets, LM3D, np.zeros(64, np.float32))
    (directory / "complete").write_text("ok\n")
    os.sync()  # the files' writeback belongs to this set-up, not to the window
    return str(directory)


def pipeline_config(sizes: dict, tmp_dir: str, dtype: str = None):
    """The port's ``PipelineConfig`` (its own class) as this configuration
    states it, with the request's temporary directory."""
    from s2v_torch.utils.config import PipelineConfig, override

    p = sizes["pipeline"]
    return override(PipelineConfig(), {
        "model.dtype": dtype or p["dtype"], "model.detector_dtype": p["detector_dtype"],
        "model.parse_size": p["parse_size"], "model.reuse_detections": p["reuse_detections"],
        "model.img_size": p["img_size"], "model.approx_warp": p["approx_warp"],
        "infer.lnet_batch_size": p["lnet_batch_size"], "infer.tmp_dir": tmp_dir})


def program(torch, sizes: dict, weights_dir: str, tmp_dir: str, device=None):
    """The ``infer`` command's objects: ``load_models`` on the weight files,
    then ``LipSyncPipeline``; returns the pipeline."""
    from s2v_torch.cli import load_models
    from s2v_torch.pipeline.inference import LipSyncPipeline

    cfg = pipeline_config(sizes, tmp_dir)
    models = load_models(weights_dir, cfg, device=device)
    return LipSyncPipeline(cfg, models, device=device)


def program_networks(pipe) -> Dict[str, object]:
    """Each network module the program runs, by role."""
    m = pipe.models
    final = m.final_enhancer.enhancer.models
    return dict(s3fd=m.s3fd, fan=m.fan, recon=m.recon, dnet=m.dnet, enet=m.enet,
                retinaface=final["retinaface"], parsenet=final["parsenet"],
                gfpgan=m.mouth_restorer.restorer.models["gfpgan"], gpen2048=final["facegan"],
                srmodel=final["srmodel"])


def _load(torch, module, path: str, key, device):
    sd = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(sd if key is None else sd[key], strict=True)
    return module.to(device).eval()


class Reference:
    """The plain reference's chain over the same weight files: Steps 1-3
    and 5 over the whole clip, then Step 6, the mouth tail and the final
    stage for the output frames asked for. ``below`` computes one precision
    under the configuration's: the networks it runs in bfloat16 in fp8
    (e4m3, per-tensor scales) and those in float32 in TF32."""

    def __init__(self, torch, sizes: dict, weights_dir: str, device, below: bool = False):
        from portbench.core.synth import CHECKPOINT_FILES
        from portbench.reference.pipeline.enhance import (FaceEnhancer, final_enhancer_hook,
                                                           reference_enhancer_hook)
        from portbench.reference.pipeline.face3d_prep import load_lm3d
        from portbench.reference.pipeline.inference import LipSyncPipeline, PipelineModels
        from portbench.reference.pipeline.restoration import make_mouth_restorer
        from portbench.reference.utils.config import InferenceConfig, ModelConfig, PipelineConfig
        from scipy.io import loadmat

        self.torch, self.below = torch, below
        roles = [r for r in ROLES if r != "gpen512"]
        nets = {r: _load(torch, n, os.path.join(weights_dir, CHECKPOINT_FILES[r][0]),
                         CHECKPOINT_FILES[r][1], device)
                for r, n in reference_networks(torch, sizes, device, roles).items()}
        p = sizes["pipeline"]
        dtype = "bfloat16" if below else "float32"
        kw = dict(dtype=dtype, parse_size=p["parse_size"], device=device)
        cfg = PipelineConfig(model=ModelConfig(dtype=dtype, detector_dtype="float32",
                                               parse_size=p["parse_size"],
                                               img_size=p["img_size"]),
                             infer=InferenceConfig(lnet_batch_size=p["lnet_batch_size"]))
        stack = {k: nets[k] for k in ("retinaface", "parsenet")}
        self.pipe = LipSyncPipeline(cfg, PipelineModels(
            s3fd=nets["s3fd"], fan=nets["fan"], recon=nets["recon"], dnet=nets["dnet"],
            enet=nets["enet"], lm3d=load_lm3d(os.path.join(weights_dir, "BFM")),
            expression=np.asarray(loadmat(os.path.join(weights_dir, "expression.mat"))
                                  ["expression_center"][0], np.float32),
            ref_enhancer=reference_enhancer_hook(FaceEnhancer(stack, in_size=512, **kw)),
            mouth_restorer=make_mouth_restorer({**stack, "gfpgan": nets["gfpgan"]}, **kw),
            final_enhancer=final_enhancer_hook(FaceEnhancer(
                {**stack, "facegan": nets["gpen2048"], "srmodel": nets["srmodel"]},
                in_size=2048, **kw))), device=device)
        self.fps = sizes["fps"]

    def outputs(self, frames: np.ndarray, wav: np.ndarray, indices: Sequence[int]) -> np.ndarray:
        """The output frames ``indices`` of the clip ``frames`` [N, H, W, 3]
        uint8 under the speech ``wav`` (float32 at 16 kHz, as the program's
        loader reads the request's file): [k, 2H, 2W, 3] uint8."""
        from portbench.core.lowp import fp8_under_autocast
        from portbench.reference import device as ref_device

        torch = self.torch
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        ref_device.TF32_INSIDE_F32 = self.below
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = self.below
        try:
            with torch.no_grad(), fp8_under_autocast(torch, self.below):
                return self._outputs(frames, wav, indices)
        finally:
            ref_device.TF32_INSIDE_F32 = False
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def _outputs(self, frames, wav, indices):
        from portbench.reference.audio.melspec import (mel_chunks_for_frames, melspectrogram,
                                                       num_mel_chunks)
        from portbench.reference.models.s3fd import pad_and_smooth_boxes
        from portbench.reference.ops.image import frames_to_nchw
        from portbench.reference.pipeline.inference import _frame_index

        torch, pipe = self.torch, self.pipe
        cfg, dev = pipe.cfg, pipe.device
        frames = np.ascontiguousarray(frames)
        frames_dev = torch.as_tensor(frames, device=dev)
        lm, boxes_full = pipe.extract_landmarks(frames_dev, return_boxes=True)
        f256, coords = pipe.ffhq_crop(frames, lm[0], frames_dev=frames_dev, device_out=True)
        semantic = pipe.extract_coeffs(f256.cpu().numpy(), pipe.extract_landmarks(f256))
        stab = pipe.stabilize(f256, semantic, one_shot=False, device_out=True)
        enhanced, _ = pipe.enhance_reference(stab)
        mel = melspectrogram(torch.from_numpy(wav).to(dev), cfg.audio)
        # synthesize (inference.py), for the outputs asked for only
        n_chunks = num_mel_chunks(mel.shape[1], self.fps)
        n_frames = min(len(enhanced), n_chunks)
        chunks = mel_chunks_for_frames(mel.float(), n_chunks, self.fps)
        fh, fw = frames.shape[1:3]
        boxes = pad_and_smooth_boxes(np.asarray(boxes_full)[:n_frames], (fh, fw),
                                     pads=cfg.infer.pads, smooth=not cfg.infer.nosmooth)
        full = frames_to_nchw(frames_dev[:n_frames], dev)
        refs = pipe.build_reference_faces(enhanced[:n_frames], frames_dev[:n_frames],
                                          tuple(int(v) for v in coords), boxes, None)
        boxes_dev = torch.as_tensor(boxes.astype(np.float32), device=dev)
        out = []
        for i in indices:
            # output i takes frame j and, as the program does, the mel chunk j
            j = _frame_index(i, n_frames, cfg.infer.static)
            ix = torch.as_tensor([j], device=dev)
            pasted = pipe._step6(full[ix], boxes_dev[ix], refs[ix], chunks[ix][:, None])
            pasted = pipe.models.mouth_restorer(pasted.permute(0, 2, 3, 1), boxes_dev[ix])
            pasted = pipe.models.final_enhancer(pasted, boxes[[j]])
            out.append(torch.as_tensor(pasted).cpu().numpy())
        return np.concatenate(out)

    def output_count(self, wav: np.ndarray) -> int:
        from portbench.reference.audio.melspec import melspectrogram, num_mel_chunks

        mel = melspectrogram(self.torch.from_numpy(wav), self.pipe.cfg.audio)
        return num_mel_chunks(mel.shape[1], self.fps)
