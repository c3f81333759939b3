"""Command-line entry of the port (s2v_tpu/cli.py's surface; reference CLI:
python3 inference.py --face --audio --outfile, flags from
futils/inference_utils.py:16-51).

    python -m s2v_torch.cli infer --face clip.npz --audio speech.wav \\
        --outfile out.npz --checkpoint_dir checkpoints
    python -m s2v_torch.cli find-audio --face clip.npz --audio speech.wav
    python -m s2v_torch.cli train --face clip.npz --audio speech.wav \\
        --checkpoint_dir checkpoints [--train.epochs 10 --train.batch_size 16]

``infer`` and ``train`` run on the card; ``main(argv, device="cpu")`` runs
them on the CPU on purpose. ``--trace_out FILE`` writes the run's spans and
counters (``s2v_torch.utils.trace``) to FILE as a Chrome trace when the
command ends. ``infer --parallel.infer_mesh true`` splits the
frames of every stage over a mesh of the cards (``--parallel.data_parallel``
of them, all by default), or of ``--parallel.data_parallel`` replicas on
the CPU under ``device="cpu"``. Checkpoints are the reference's torch
files, loaded as they are (``s2v_torch.utils.weights.load_reference``) into
modules whose geometry is read from each file's state_dict:

- s3fd.pth (S3FD), 2DFAN4-cd938726ad.zip or 2DFAN4.pth (FAN, 4 modules),
  face3d_pretrain_epoch_20.pth (ReconNet, under ``net_recon``), DNet.pt
  (under ``net_G_ema``), ENet.pth + LNet.pth (under ``state_dict``; ENet's
  own LNet keys give way to LNet.pth's), BFM/similarity_Lm3D_all.mat and
  expression.mat;
- the restoration stack, each also found under ``weights/``:
  RetinaFace-R50.pth, ParseNet-latest.pth, GFPGANv1.4.pth or GFPGANv1.3.pth
  (under ``params_ema``; GFPGANv1Clean), else GFPGANv1.pth (the original
  arch, under ``params_ema``), GPEN-BFR-512.pth (its presence enables Step
  5, which runs no GPEN), GPEN-BFR-2048.pth and realesrnet_x2.pth (under
  ``params_ema``; the final 2x stage);
- 30_net_gen.pth or ganimation.pth (GANimation's SplitGenerator; the
  ``--up_face`` edit, which takes effect under ``--without_rl1``);
- for ``train``, vgg16-397923af.pth or vgg16.pth (torchvision's VGG16; its
  perceptual term, else the pyramid stand-in).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from s2v_torch.utils import trace


@trace.span("setup.load_models")
def load_models(checkpoint_dir: str, cfg=None, device=None, mesh=None):
    """PipelineModels from a directory of reference checkpoints, with the
    file names, fallbacks and precedence of s2v_tpu's ``load_models``; the
    modules live on ``device`` (the card unless ``"cpu"`` is asked for), or
    on the first device of ``mesh`` (a ``FrameMesh``), which the hooks then
    split their frames over (pass the same mesh to ``LipSyncPipeline``).
    RetinaFace and ParseNet are one module each, shared by Step 5, the
    mouth tail and the final stage."""
    from s2v_torch.device import resolve_device
    from s2v_torch.models.dnet import dnet_arch
    from s2v_torch.models.enet import enet_arch
    from s2v_torch.models.fan import FAN
    from s2v_torch.models.ganimation import ganimation_arch
    from s2v_torch.models.gfpgan import gfpgan_arch
    from s2v_torch.models.gpen import fullgenerator_arch
    from s2v_torch.models.parsenet import parsenet_arch
    from s2v_torch.models.resnet import recon_arch
    from s2v_torch.models.retinaface import retinaface_arch
    from s2v_torch.models.rrdbnet import rrdbnet_arch
    from s2v_torch.models.s3fd import S3FD
    from s2v_torch.pipeline.enhance import (FaceEnhancer, final_enhancer_hook,
                                            reference_enhancer_hook)
    from s2v_torch.pipeline.inference import PipelineModels
    from s2v_torch.pipeline.restoration import make_mouth_restorer, make_up_face_editor
    from s2v_torch.utils.config import PipelineConfig
    from s2v_torch.utils.weights import (load_reference, load_torch_checkpoint,
                                         merge_enet_lnet)

    cfg = cfg if cfg is not None else PipelineConfig()
    device = mesh.first if mesh is not None else resolve_device(device)

    def maybe(path):
        full = os.path.join(checkpoint_dir, path)
        return full if os.path.isfile(full) else None

    def maybe_weights(name):
        return maybe(name) or maybe(os.path.join("weights", name))

    def build(make, sd, **kw):
        """The module of ``sd``'s geometry, built on the device and loaded
        strictly: a file whose keys or shapes do not fit raises."""
        with torch.device(device):
            module = make(sd, **kw)
        return load_reference(module, sd).to(device).eval()

    models = PipelineModels()
    if maybe("s3fd.pth"):
        models.s3fd = build(lambda sd: S3FD(),
                            load_torch_checkpoint(maybe("s3fd.pth"), key=None))
    fan_path = maybe("2DFAN4-cd938726ad.zip") or maybe("2DFAN4.pth")
    if fan_path:
        models.fan = build(lambda sd: FAN(num_modules=4),
                           load_torch_checkpoint(fan_path, key=None))
    if maybe("face3d_pretrain_epoch_20.pth"):
        models.recon = build(recon_arch, load_torch_checkpoint(
            maybe("face3d_pretrain_epoch_20.pth"), key="net_recon"))
    if maybe("DNet.pt"):
        models.dnet = build(dnet_arch, load_torch_checkpoint(maybe("DNet.pt"), key="net_G_ema"))
    if maybe("ENet.pth") and maybe("LNet.pth"):
        models.enet = build(enet_arch, merge_enet_lnet(load_torch_checkpoint(maybe("ENet.pth")),
                                                       load_torch_checkpoint(maybe("LNet.pth"))))
    bfm = os.path.join(checkpoint_dir, "BFM")
    if os.path.isdir(bfm):
        from s2v_torch.pipeline.face3d_prep import load_lm3d

        models.lm3d = load_lm3d(bfm)
    if maybe("expression.mat"):
        from scipy.io import loadmat

        mat = loadmat(maybe("expression.mat"))
        models.expression = np.asarray(mat["expression_center"][0], np.float32)

    # --- the restoration stack (RetinaFace / ParseNet / GFPGAN / GPEN) ---
    aux = {}
    if maybe_weights("RetinaFace-R50.pth"):
        aux["retinaface"] = build(retinaface_arch, load_torch_checkpoint(
            maybe_weights("RetinaFace-R50.pth"), key=None))
    if maybe_weights("ParseNet-latest.pth"):
        aux["parsenet"] = build(parsenet_arch, load_torch_checkpoint(
            maybe_weights("ParseNet-latest.pth"), key=None))
    gfp_path = maybe("GFPGANv1.4.pth") or maybe("GFPGANv1.3.pth")
    if gfp_path:
        aux["gfpgan"] = build(gfpgan_arch, load_torch_checkpoint(gfp_path, key="params_ema"))
    elif maybe("GFPGANv1.pth"):
        # the original arch with GFPGANer's wiring for it (gfpgan/utils.py:63-74)
        aux["gfpgan"] = build(gfpgan_arch, load_torch_checkpoint(maybe("GFPGANv1.pth"),
                                                                 key="params_ema"),
                              arch="original", input_is_latent=True, different_w=True,
                              sft_half=True)
    dtype, parse_size = cfg.model.dtype, cfg.model.parse_size
    opts = dict(approx_warp=cfg.model.approx_warp, det_dtype=cfg.model.detector_dtype,
                mesh=mesh)
    stack = "retinaface" in aux and "parsenet" in aux
    if maybe_weights("GPEN-BFR-512.pth") and stack:
        # Step 5 (inference.py:225-227,234-238; cli.py's ref_enhancer):
        # face_enhance=False, so GPEN-BFR-512 is never run, nor built here
        models.ref_enhancer = reference_enhancer_hook(FaceEnhancer(
            {k: aux[k] for k in ("retinaface", "parsenet")}, in_size=512, dtype=dtype,
            parse_size=parse_size, device=device, **opts))

    # the final full-frame stage: GPEN-BFR-2048 + RealESRNet x2, output at
    # twice the input's size (inference.py:228-231,246,317-330)
    gpen2048 = maybe_weights("GPEN-BFR-2048.pth")
    if gpen2048 and stack:
        final = {"retinaface": aux["retinaface"], "parsenet": aux["parsenet"],
                 "facegan": build(fullgenerator_arch, load_torch_checkpoint(gpen2048, key=None),
                                  size=2048)}
        rrdb_path = maybe_weights("realesrnet_x2.pth")
        if rrdb_path:
            final["srmodel"] = build(rrdbnet_arch, load_torch_checkpoint(
                rrdb_path, key="params_ema"), scale=2)
        # the hook hands the boxes on as (y1, y2, x1, x2) (cli.py:156-162)
        models.final_enhancer = final_enhancer_hook(FaceEnhancer(
            final, in_size=2048, dtype=dtype, parse_size=parse_size, device=device, **opts))
    # det_dtype sets the tail's ParseNet too (s2v_tpu's cli.py:173)
    models.mouth_restorer = make_mouth_restorer(aux, parse_size=parse_size, dtype=dtype,
                                                device=device, **opts)
    gani_path = maybe("30_net_gen.pth") or maybe("ganimation.pth")
    if gani_path:
        models.ganimation = build(ganimation_arch, load_torch_checkpoint(gani_path, key=None))
        # --up_face (inference.py:250-253,267-281): the GANimation edit of
        # the upper face, composited through the --without_rl1 mask
        models.up_face_editor = make_up_face_editor({"ganimation": models.ganimation},
                                                    cfg.infer.up_face, device=device, mesh=mesh)
    return models


# module name -> (file, the key the reference file keeps its state_dict under)
CHECKPOINT_FILES = {
    "s3fd": ("s3fd.pth", None), "fan": ("2DFAN4.pth", None),
    "recon": ("face3d_pretrain_epoch_20.pth", "net_recon"), "dnet": ("DNet.pt", "net_G_ema"),
    "enet": ("ENet.pth", "state_dict"), "retinaface": ("RetinaFace-R50.pth", None),
    "parsenet": ("ParseNet-latest.pth", None), "gfpgan": ("GFPGANv1.4.pth", "params_ema"),
    "gfpgan_v1": ("GFPGANv1.pth", "params_ema"), "ganimation": ("30_net_gen.pth", None),
    "gpen512": ("GPEN-BFR-512.pth", None), "gpen2048": ("GPEN-BFR-2048.pth", None),
    "srmodel": ("realesrnet_x2.pth", "params_ema"), "vgg16": ("vgg16.pth", None),
}


def write_checkpoint_dir(directory: str, modules: dict, lm3d=None, expression=None) -> str:
    """The inverse of ``load_models``: ``modules`` (names of
    ``CHECKPOINT_FILES``) saved with ``torch.save`` as reference-format files
    in ``directory``; ENet's LNet also as LNet.pth, a ``vgg16``
    (``VGG16Features``) as the torchvision-layout vgg16.pth that ``train``
    reads. ``lm3d`` [5, 3] goes into
    BFM/similarity_Lm3D_all.mat at the 68-point rows ``load_lm3d`` reads,
    ``expression`` [64] into expression.mat. Returns ``directory``."""
    from scipy.io import savemat

    os.makedirs(directory, exist_ok=True)

    def save(sd, name, key):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(sd if key is None else {key: sd}, os.path.join(directory, name))

    for name, module in modules.items():
        sd = module.state_dict()
        if name == "gfpgan_v1":  # basicsr's FIRs are no buffers (models/gfpgan.py)
            sd = {k: v for k, v in sd.items() if not k.endswith(".kernel")}
        save(sd, *CHECKPOINT_FILES[name])
        if name == "enet":
            save({k[len("low_res."):]: v for k, v in sd.items() if k.startswith("low_res.")},
                 "LNet.pth", "state_dict")
    if lm3d is not None:
        lm = np.zeros((68, 3))
        for rows, point in zip(((36, 39), (42, 45), (30,), (48,), (54,)), lm3d):
            lm[list(rows)] = point
        os.makedirs(os.path.join(directory, "BFM"), exist_ok=True)
        savemat(os.path.join(directory, "BFM", "similarity_Lm3D_all.mat"), {"lm": lm})
    if expression is not None:
        savemat(os.path.join(directory, "expression.mat"),
                {"expression_center": np.asarray(expression, np.float32)[None]})
    return directory


def parse_args(argv):
    """argv (without the command) -> PipelineConfig. Reference-style flat
    flags (futils/inference_utils.py options()) map onto infer.*; dotted
    keys address the config tree directly; --config overlays a file first.
    An unknown flag exits, an unknown dotted key raises ValueError.
    """
    flat_flags = {
        "config",
        "face", "audio", "outfile", "exp_img", "up_face", "fps", "pads",
        "static", "one_shot", "tmp_dir", "re_preprocess", "checkpoint_dir",
        "cropped_image", "nosmooth", "without_rl1", "box", "crop",
        "face_det_batch_size", "lnet_batch_size", "LNet_batch_size",
    }
    overrides = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key = a[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                i += 1
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                if key in ("box", "crop", "pads"):
                    # nargs='+'-style tuples (inference.py --box/--crop/--pads)
                    vals = []
                    i += 1
                    while i < len(argv) and not argv[i].startswith("--"):
                        vals.append(argv[i])
                        i += 1
                    val = ",".join(vals)
                else:
                    val = argv[i + 1]
                    i += 2
            else:
                val = "true"
                i += 1
            if "." in key:
                overrides[key] = val
            elif key == "config":
                overrides["config"] = val
            elif key in flat_flags:
                if key == "LNet_batch_size":
                    key = "lnet_batch_size"
                overrides[f"infer.{key}"] = val
            else:
                raise SystemExit(f"unknown flag --{key}")
        else:
            i += 1
    from s2v_torch.utils.config import PipelineConfig, load_config_file, override

    cfg = PipelineConfig()
    if "config" in overrides:  # --config file.json|py|yml applied first,
        cfg = load_config_file(overrides.pop("config"), base=cfg)
    return override(cfg, overrides)  # explicit flags win


def find_audio(cfg) -> str:
    """inference.py:414-468 find_best_audio: the database wav (the other
    .wav files beside --audio) with the smallest fastdtw distance to
    --audio, cached per clip basename under tmp_dir unless --re_preprocess."""
    import glob

    from s2v_torch.audio.dtw import find_best_audio
    from s2v_torch.io.audio_io import load_wav

    base = os.path.basename(cfg.infer.face)
    cache_path = os.path.join(cfg.infer.tmp_dir, f"{base}_best_audio.npy")
    if os.path.isfile(cache_path) and not cfg.infer.re_preprocess:
        return str(np.load(cache_path))
    src = load_wav(cfg.infer.audio, cfg.audio.sample_rate)
    database = {
        f: load_wav(f, cfg.audio.sample_rate)
        for f in sorted(glob.glob(os.path.join(os.path.dirname(cfg.infer.audio), "*.wav")))
        if os.path.abspath(f) != os.path.abspath(cfg.infer.audio)
    }
    if not database:
        raise SystemExit("no other .wav files next to --audio")
    best, dist = find_best_audio(np.asarray(src), database)
    os.makedirs(cfg.infer.tmp_dir, exist_ok=True)
    np.save(cache_path, best)
    print(f"distance: {dist:.1f}")
    return best


def train_inputs(cfg, device=None):
    """What the ``train`` command trains on: Steps 1-3 on the clip (no
    artifact cache, as s2v_tpu's branch), then ENet batches from DNet's
    stabilised frames (``build_enet_batches``). Returns (the pipeline over
    ``load_models``' modules, the batches, the torchvision VGG16 of the
    checkpoint directory as ``VGG16Features`` or None without that file)."""
    from s2v_torch.audio import melspectrogram
    from s2v_torch.io.audio_io import load_wav
    from s2v_torch.io.video_io import VideoReader
    from s2v_torch.models.vgg import vgg16_features
    from s2v_torch.pipeline.inference import LipSyncPipeline
    from s2v_torch.train.data import build_enet_batches
    from s2v_torch.utils.weights import load_torch_checkpoint

    models = load_models(cfg.infer.checkpoint_dir, cfg, device=device)
    if models.enet is None:
        raise RuntimeError("train needs ENet.pth and LNet.pth in the checkpoint directory")
    pipe = LipSyncPipeline(cfg, models, device=device)
    reader = VideoReader(cfg.infer.face)
    frames = reader.read_all()
    fps = reader.fps or cfg.infer.fps
    lm = pipe.extract_landmarks(frames)
    frames_256, coords = pipe.ffhq_crop(frames, lm[0])
    semantic = pipe.extract_coeffs(frames_256, pipe.extract_landmarks(frames_256))
    stabilized = pipe.stabilize(frames_256, semantic)
    wav = load_wav(cfg.infer.audio, cfg.audio.sample_rate)
    mel = melspectrogram(torch.from_numpy(wav).to(pipe.device), cfg.audio)
    batches = build_enet_batches(pipe, stabilized, mel, frames, coords, fps,
                                 batch_size=cfg.train.batch_size)
    vgg = None
    for name in ("vgg16-397923af.pth", "vgg16.pth"):
        path = os.path.join(cfg.infer.checkpoint_dir, name)
        if os.path.isfile(path):
            vgg = vgg16_features(load_torch_checkpoint(path, key=None))
            break
    return pipe, batches, vgg


def train(cfg, device=None):
    """The ``train`` command (s2v_tpu cli.py:274-323, reference
    training.py): ``train_inputs``, then ``finetune`` of ENet's style convs
    with the VGG16 perceptual term when a torchvision VGG16 file is in the
    checkpoint directory and ReconNet's identity term when ReconNet is.
    Checkpoints go to ``tmp_dir/enet_ckpt``, the log to
    ``tmp_dir/train_log.jsonl``. Returns the final ``TrainState``."""
    from s2v_torch.train.finetune_enet import finetune, make_id_embed_fn

    pipe, batches, vgg = train_inputs(cfg, device)
    recon = pipe.models.recon
    state = finetune(pipe.models.enet, batches, cfg.train, device=pipe.device,
                     checkpoint_dir=os.path.join(cfg.infer.tmp_dir, "enet_ckpt"),
                     log_path=os.path.join(cfg.infer.tmp_dir, "train_log.jsonl"),
                     id_embed_fn=make_id_embed_fn(recon) if recon is not None else None,
                     vgg=vgg)
    print(f"trained {state.step} steps")
    return state


def build_mesh(cfg, device=None):
    """The ``infer`` mesh of config ``parallel`` (s2v_tpu's ``main``: all
    devices, ``data_parallel x model_parallel``), None unless
    ``parallel.infer_mesh``. On the cards by default; with a ``device`` (say
    "cpu"), ``data_parallel`` (1 when -1) times ``model_parallel`` replicas
    on it."""
    from s2v_torch.parallel.mesh import make_mesh

    par = cfg.parallel
    if not par.infer_mesh:
        return None
    if device is None:
        return make_mesh(par.data_parallel, par.model_parallel)
    n = max(par.data_parallel, 1) * par.model_parallel
    return make_mesh(par.data_parallel, par.model_parallel, devices=[device] * n)


def main(argv=None, device=None):
    """``infer`` (the default command), ``train`` or ``find-audio``;
    ``device`` as ``load_models``'s. ``bench`` is not ported yet. With
    ``--trace_out FILE`` the process's spans and counters are written to
    FILE (``s2v_torch.utils.trace.write_chrome``) when the command ends,
    also when it fails."""
    argv = list(sys.argv[1:] if argv is None else argv)
    command = argv.pop(0) if argv and not argv[0].startswith("--") else "infer"
    trace_out = _pop_flag(argv, "trace_out")
    cfg = parse_args(argv)
    try:
        return _run_command(command, cfg, device)
    finally:
        if trace_out is not None:
            print("trace:", trace.write_chrome(trace_out))


def _pop_flag(argv: list, name: str):
    """The value of ``--name VALUE`` or ``--name=VALUE`` in ``argv``, taken
    out of it; None when absent."""
    for i, a in enumerate(argv):
        if a.startswith(f"--{name}="):
            return argv.pop(i).split("=", 1)[1]
        if a == f"--{name}" and i + 1 < len(argv):
            del argv[i]
            return argv.pop(i)
    return None


def _run_command(command: str, cfg, device):
    if command == "infer":
        from s2v_torch.pipeline.inference import LipSyncPipeline

        mesh = build_mesh(cfg, device)
        models = load_models(cfg.infer.checkpoint_dir, cfg, device=device, mesh=mesh)
        pipe = LipSyncPipeline(cfg, models, device=device, mesh=mesh)
        out = pipe.run(cfg.infer.face, cfg.infer.audio, cfg.infer.outfile)
        print("outfile:", out)
        return out
    if command == "find-audio":
        best = find_audio(cfg)
        print("best_audio:", best)
        return best
    if command == "train":
        return train(cfg, device)
    if command == "bench":
        raise NotImplementedError(
            "s2v_torch does not port the bench command (the port's benchmark) yet "
            "(ROADMAP.md, queue 1); s2v_tpu.cli has it")
    raise SystemExit(f"unknown command {command!r}; use infer|train|find-audio")


if __name__ == "__main__":
    main()
