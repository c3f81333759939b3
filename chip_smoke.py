"""Quickest proof that the s2v_torch port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--package DIR]

The second form runs phases 1 and 2 alone, with the s2v_torch package
found in DIR when given (say a ``git archive`` of another commit), so two
commits' kernels can be timed on one card in one call.

Phases, each printed as it ends; any failure exits nonzero without the
result line:

1. build: compile every CUDA kernel of the port from s2v_torch/csrc (one
   nvcc per source, all started together) and print the build seconds and
   each kernel's registers, shared memory per block and spills.
2. kernels: call each kernel's wrapper at the shapes GPEN-BFR-2048 gives it
   on the inference path (from the 9x9 blur after its first transposed conv
   to the 2049x2049 one after its last, plus a down=2 and a negative-pad
   upfirdn2d case)
   and at the shapes GPEN-BFR-512 training gives it (K1 and K2 at the last
   StyledConv's [4, 128, 512, 512], K2 with and without b; K3's forward and
   backward configurations) and hold it against its plain PyTorch version,
   in f32 and bf16; print the error against its tolerance, the kernel, plain
   and library times (CUDA events), the least time the card could take and
   the kernel's share of it. Speed fails nothing; a disagreement does.
   Then the same at the component discriminators' shapes in GFPGAN
   training (K1, K2 at [3, 64, 120, 120]; K3 there and on the eye crops'
   40^2 planes, forward and backward), and at the original GFPGANv1(512)'s
   largest shapes in the mouth tail (bf16, batch 7). Inputs that fit in
   the 50 MB L2 twice over are timed cold (``event_ms``).
3. reference: the Step 6 slice at slim widths on the card (kernels) and on
   the CPU (plain versions), f32, must agree on the output frames.
4. steps reference: Steps 1-3 (``extract_landmarks``, ``ffhq_crop``,
   ``extract_coeffs``, ``stabilize``) on the card and on the CPU from the
   same weights on three 192x160 frames, f32: S3FD and FAN at full width,
   ReconNet and DNet slim. S3FD's maps and FAN's heatmaps on identical
   inputs within 1e-4 of their scale; boxes and landmarks within 1e-2 px
   where the top-2 margin of their score or heatmap exceeds 1e-4 (of the
   heatmaps' scale), at least 90% of them; crops within one gray level;
   coefficients within 1e-4 of their scale; stabilised frames as the slim
   slice's.
5. retina reference: RetinaFace-R50 at full width on the card and on the
   CPU, f32, on two 256^2 frames and one 1024^2 frame: loc, conf and
   landms within 1e-4 of their scale, the best box and landmarks within
   1e-2 and 5e-2 px where the top-2 score margin exceeds twice the
   measured score difference (every frame must qualify), every frame
   valid; then the slim Step-5 enhancer and the slim final hook without
   landmarks (RetinaFace cfg_mnet detecting) on both, within one gray
   level, every frame valid.
6. mouth reference: the Step-6 mouth tail at slim widths on the card and on
   the CPU from the same weights, f32: GFPGANv1Clean at out_size 64
   (num_style_feat 64, channel_multiplier 0.5, narrow 0.5), RetinaFace
   cfg_mnet and a slim ParseNet; the hook (``make_mouth_restorer``)
   detecting and with ``landmarks5`` on four 96x112 frames, and the slim
   non-SR ``possion`` composite of ``FaceEnhancer``, within one gray level,
   every face valid, the mouth mask covering the boxes and the tail moving
   their pixels by 5 gray levels or more on average; the 10-level
   ``laplacian_pyramid_blend`` at 512^2 within 1e-3 (0..255), with its
   device ms at the chain's batch.
7. slice: the chained main path in the default configuration
   (``reuse_detections=False``) at full width, random weights from a fixed
   seed: 8 synthetic 512x512 frames -> ``extract_landmarks`` (boxes kept)
   -> ``ffhq_crop`` -> ``extract_landmarks`` on the crops ->
   ``extract_coeffs`` -> ``stabilize`` -> ``enhance_reference`` (Step 5:
   RetinaFace + ParseNet at 512^2, ``face_enhance=False``) ->
   ``melspectrogram`` (0.4 s of synthetic speech) -> ``synthesize`` with
   the mouth tail (RetinaFace, GFPGANv1Clean and ParseNet's mouth mask at
   512^2, the 10-level blend) and the final hook (RetinaFace on the
   bilinear-2x 1024^2 frames), S3FD (VGG16), FAN (2DFAN4), ReconNet
   (ResNet50), DNet, RetinaFace-R50, ENet/LNet, GFPGANv1Clean(512),
   GPEN-BFR-2048, ParseNet and RealESRNet x2 at their production widths,
   RetinaFace and ParseNet shared by Step 5, the tail and the final stage
   as cli.py shares them. Random detector weights find no face, so the
   face-class bias of S3FD's stride-4 head is raised by 20 and RetinaFace's
   level-2 face logit by 4 (``with_face_logit``), and its level-2 landmark
   head set to the facexlib template's layout (``with_face_landmarks``:
   random landmarks lie a few pixels apart and the face crops would cover
   a speck of the frame); every frame must have a
   valid face in Step 5, in the mouth tail and in the final stage.
   ParseNet's class-11 logit (the upper lip, 255 in the face and in the
   mouth colormap) is raised (``with_face_mask``, here and in the slim
   phases), so the whole crop is pasted back and the mouth mask covers the
   whole box; the mask's coverage and the tail's mean change inside the
   boxes are printed and checked. Where a step's geometry
   comes from landmarks (the FFHQ crop, the 3DMM alignment, the reference
   faces) synthetic ones stand in, with a synthetic lm3d and a zero
   expression. The launch counts are reset just before this run and read
   just after; each kernel must have run, 38 and 27 times per frame (K2
   not at all). Per step: synchronised wall ms (Step 5 split into
   detection, warp + parse, paste + composite; the mouth tail and the final
   stage per call, synchronised at their ends only) and, from one more run
   with each step under its own torch.profiler session, device ms and the
   top kernels, and from a last run the tail's device ms split into
   detection, restore + paste and parse + blend; the final stage's
   RetinaFace pass timed alone (CUDA events and a synchronised host clock),
   so nothing synchronises inside the final stage or the tail.
8. cli: the ``infer`` command at full width from checkpoint files. The
   slice's seeded modules (and a GPEN-BFR-512, whose presence enables Step
   5) are saved with ``torch.save`` as reference-format files in a
   temporary directory outside the checkout (the weight edits above travel
   in the files), with BFM/similarity_Lm3D_all.mat and expression.mat
   holding the synthetic lm3d and a zero expression; the slice's clip is
   written as .npz and .wav. Then ``s2v_torch.cli.main(["infer", ...])``
   runs three times with one --tmp_dir: cold, warm (the artifact cache
   hit: Steps 1-3 and 5 must not be called, counted per method) and with
   --re_preprocess. Landmark-driven geometry comes from the random FAN
   (the CLI has no injection): the S3FD box is the corner anchor's, so the
   FFHQ quad covers a ~20 px corner of the frame. Each run: 7 frames of
   1024x1024x3 uint8 out, K1 and K3 launched 38 and 27 times per frame,
   every face valid in Step 5, the mouth tail and the final stage, and an
   output within one gray level of the cold run's for all but 0.1% of its
   subpixels. Then ``LipSyncPipeline.run`` three times more on the models
   the last ``main`` loaded (the same checks), the third with the landmark
   sweeps under torch.profiler. Printed: load_models seconds, each run's
   wall and frames/s, per-step wall (synchronised at each step's ends),
   peak memory, the allocator segments each run added, the profiled
   sweep's top kernels.
9. train command: ``s2v_torch.cli.main(["train", ...,
   "--train.batch_size", "4", "--train.epochs", "3"])`` on the CLI phase's
   checkpoint directory, with a random torchvision-layout vgg16.pth added,
   and its clip: Steps 1-3, ``build_enet_batches`` (7 frames, 2 batches),
   6 fine-tune steps of ENet's style convs at full width (ENet/LNet 158.9M)
   with the VGG16 perceptual and ReconNet identity terms, f32 without TF32.
   Checks: 6 steps, finite losses, only ``style_convs.*`` changed against
   the ENet in the files, the last checkpoint restores the trained ENet bit
   for bit, no kernel launched (ENet, VGG16 and ReconNet have no GPEN
   layer). Printed: load_models s, batch-building s, synchronised ms per
   step, peak memory.
10. train reference: one R1 d_step, one g_step and one plain d_step of
   ``s2v_torch.train.gan.make_gan_trainer`` at slim widths on the card and
   on the CPU from the same weights and batch; metrics and every parameter
   gradient must agree.
11. train: GPEN-BFR-512 (FullGenerator and Discriminator at full width,
   random weights from a fixed seed), batch 4 at 512^2 from
   ``face_batches`` over 8 synthetic faces, step pairs 0-16 (R1 at 0 and
   16), f32. The launch counts are reset just before and read just after;
   every step's K1, K2 and K3 launches must equal the counts that
   ``s2v_torch.train.gan.expected_train_launches`` derives from the models.
   Then one g_step under torch.profiler.
12. finetune reference: one slim ENet fine-tune step with the VGG16 and
   slim-ReconNet identity terms on the card and on the CPU from the same
   weights (``phase_finetune_reference`` states the tolerances).
13. gfpgan reference: one g_step and one d_step of
   ``s2v_torch.train.gfpgan_train.make_gfpgan_trainer`` at slim widths
   (GFPGANv1Clean, GPEN D, component discriminators on 16^2 crops, VGG16,
   IR-SE50) on the card and on the CPU; metrics, every gradient and the
   launch counts of ``expected_gfpgan_launches``.
14. gfpgan train: GFPGANv1Clean(512), Discriminator(512,
   channel_multiplier=1), three FacialComponentDiscriminators (eyes 80^2,
   mouth 120^2 crops around the facexlib template's points, jittered),
   VGG16 and IR-SE50 at full width, random weights from seed 0, batch 3 at
   512^2 from ``face_batches`` (JPEG off), step pairs 0-4, f32, the
   generator's lr ``GFPGAN_G_LR``; every step's metrics must be finite and
   its K1, K2 and K3 launches equal ``expected_gfpgan_launches``.
   Then one g_step under torch.profiler.
15. options reference (run after phase 6): the slim Step 6 with every
   opt-in ``infer`` setting at once (the original GFPGANv1 in the mouth
   tail, --without_rl1 with the --up_face surprise GANimation edit, --box
   past the frame's sides, --cropped_image, model.approx_warp) on the card
   and on the CPU, f32, within one gray level, every face valid; then with
   model.detector_dtype=bfloat16 too (RetinaFace's landmarks from live
   features, ``with_live_landmarks``), the card's bf16 output within twice
   the CPU's own bf16-vs-f32 difference, which must not be 0
   (``phase_options_reference``).
16. infer options (run after phase 9, on phase 8's files): the CLI's
   directory with GFPGANv1.4.pth swapped for a random GFPGANv1.pth (the
   original arch at full width) and a random 30_net_gen.pth added; three
   cold ``infer`` runs through ``s2v_torch.cli.main``: --up_face surprise
   --without_rl1; --box --cropped_image; --model.detector_dtype bfloat16
   --model.approx_warp true. Each: load_models s, run wall, frames/s, peak
   memory, every face valid, K1 and K3 launches held to the chain's plus
   GFPGANv1's ``forward_launches`` per tail forward; the third run's Step
   5 against the second's on the same frames with a face supplied inside
   them, on smooth frames over 40 dB; the sheared warp against the exact
   one at Step 5's and the tail's shapes, over 45 dB, and card vs CPU
   (``run_options``, ``approx_warp_checks``).

17. infer mesh (run after phase 8, on its files and clip):
   ``s2v_torch.cli.main(["infer", ..., "--parallel.infer_mesh", "true"])``
   on the one-card mesh, then ``load_models(..., mesh=make_mesh(devices=
   ["cuda:0", "cuda:0"]))`` and ``LipSyncPipeline.run`` with two replicas on
   the card, so that every stage's split and gather run on the device. Each
   output within one gray level of phase 8's cold run on all but 0.1% of its
   subpixels, every face valid, and K1/K3 launches equal to the count
   derived from GPEN-BFR-2048's kernel sites and the forwards the mesh's
   chunking gives (``run_infer_mesh``).
18. gan data-parallel: a one-rank NCCL group (``FileStore``); GPEN-BFR-512
   step pairs 0-1 (R1 at 0) at phase 11's batch through
   ``make_gan_trainer(..., mesh=make_process_mesh())`` against the trainer
   without a mesh from the same state and batch: pair 0's gradients (R1's
   D step, then G's) within 1e-3 and the parameters after both pairs
   within 1e-4 relative L2 (``GAN_DP_TOL``), launches per step equal to
   ``expected_train_launches``. Then two gloo ranks sharing the card (NCCL
   refuses two ranks on one device), each on half the batch, within the
   same bounds of the one-rank run with both ranks' replicas bit-equal,
   and the same two ranks with the minibatch stddev taken over each rank's
   own half (a planted fault) outside them; if gloo refuses a collective
   on CUDA tensors, a line names it and that check stays in the CPU tests
   (``phase_gan_dp``).
19. arcface: ``make_arcface_trainer`` at full width on the one-rank NCCL
   mesh (IResNet-50, 512-d, 112^2, batch 128, 85,742 classes: arcface_torch's
   configs/ms1mv2_r50.py), a new random batch each step, f32: 5 steps at
   sample_rate 1.0 and 5 from a fresh state at 0.1, ms per step and peak
   memory printed, finite losses, and at 0.1 the classifier rows changed
   only where some step sampled them and at every positive; then the slim
   trainer ((1, 1, 1, 1), 64-d, 16 classes, lr 1e-3, weight decay 0.5) on
   the card and on the CPU from the same state and batch, each of 2 steps'
   updates and the state within ``ARC_SLIM_TOL`` (``phase_arcface``).

Every time printed stands beside the card's name and power limit (printed
first). The line before the last is one JSON object with every kernel's
numbers, its launches summed over the main paths (the inference slice, the
CLI's cold run, the first opt-in infer run, the one-card mesh run, GPEN
training, the train command, GFPGAN training and the one-rank data-parallel
GPEN steps) and split by path; the last is
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json. TF32 is off throughout (f32 convs and matmuls
run in full f32; the pipeline keeps S3FD, FAN and ReconNet so regardless).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM, outside the tensor cores
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's clocks
L2_BYTES = 50 * 2 ** 20    # the H100's L2
L2_FLUSH_BYTES = 4 * L2_BYTES
FAILURES = []


def fail(msg):
    FAILURES.append(msg)
    print(f"FAIL: {msg}", flush=True)


def synthetic_landmarks(n, h, w, rng):
    """Plausible 68-point face landmarks centred in the frame."""
    lm = np.zeros((n, 68, 2), np.float32)
    cx, cy, s = w / 2, h / 2, min(h, w) * 0.25
    t = np.linspace(-np.pi / 2, np.pi / 2, 17)
    lm[:, 0:17, 0] = cx + np.sin(t) * s
    lm[:, 0:17, 1] = cy + np.cos(t) * s * 1.1
    lm[:, 17:22, 0] = cx - s * 0.6 + np.arange(5) * s * 0.2
    lm[:, 17:22, 1] = cy - s * 0.5
    lm[:, 22:27, 0] = cx + s * 0.1 + np.arange(5) * s * 0.15
    lm[:, 22:27, 1] = cy - s * 0.5
    lm[:, 27:31, 0] = cx
    lm[:, 27:31, 1] = cy - s * 0.3 + np.arange(4) * s * 0.15
    lm[:, 31:36, 0] = cx - s * 0.2 + np.arange(5) * s * 0.1
    lm[:, 31:36, 1] = cy + s * 0.15
    lm[:, 36:42, 0] = cx - s * 0.45 + (np.arange(6) % 3) * s * 0.1
    lm[:, 36:42, 1] = cy - s * 0.25 + (np.arange(6) // 3) * s * 0.05
    lm[:, 42:48, 0] = cx + s * 0.25 + (np.arange(6) % 3) * s * 0.1
    lm[:, 42:48, 1] = cy - s * 0.25 + (np.arange(6) // 3) * s * 0.05
    t2 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    lm[:, 48:60, 0] = cx + np.cos(t2) * s * 0.35
    lm[:, 48:60, 1] = cy + s * 0.55 + np.sin(t2) * s * 0.15
    t3 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    lm[:, 60:68, 0] = cx + np.cos(t3) * s * 0.2
    lm[:, 60:68, 1] = cy + s * 0.55 + np.sin(t3) * s * 0.08
    return lm + rng.randn(n, 1, 2).astype(np.float32) * 0.5


def event_ms(torch, fn, args=(), iters=10, warmup=2):
    """Device ms per call of ``fn(*args)``. The calls queue behind a spin
    kernel of some 20 ms, so the start event runs only once they are all
    enqueued: the events time the device, not the host's enqueue (a
    wrapper's Python costs tens of microseconds, more than a small layer's
    kernel). Tensors in ``args`` that fit in the L2 twice over are timed
    cold, as a layer's caller meets them: each call gets its own clone of
    them and keeps its output, and a read of ``L2_FLUSH_BYTES`` before the
    spin evicts them all, so every call reads its inputs from HBM and
    writes fresh lines (without that, 11 MB planes read "101% of bound")."""
    nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    cold = 0 < nbytes < 2 * L2_BYTES
    sets = ([tuple(a.clone() if torch.is_tensor(a) else a for a in args)
             for _ in range(warmup + iters)] if cold else [args] * (warmup + iters))
    for a in sets[:warmup]:
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    outs = []
    if cold:
        flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
        flush.sum()  # leaves clean lines behind: nothing to write back later
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for a in sets[warmup:]:
        out = fn(*a)
        if cold:  # a fresh output buffer for each call
            outs.append(out)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(torch, fn, iters=5):
    """Host ms per synchronised call of ``fn``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    from s2v_torch.ops.kernels import _build

    t = time.perf_counter()
    _build.build(["fused_act", "upfirdn2d"])
    secs = time.perf_counter() - t
    print(f"build: {secs:.1f} s (nvcc, sm_90a, both sources in parallel: K1 and K2 in "
          "fused_act.cu, K3 in upfirdn2d.cu)")
    for name in ("fused_act", "upfirdn2d"):
        for fn, use in ptxas_usage(_build.library_path(name).with_suffix(".log")).items():
            print(f"  ptxas {name}: {fn}: {use['registers']} registers, {use['smem']} bytes "
                  f"shared memory per block, {use['stack']} bytes stack, {use['spill']} bytes "
                  "spilled")
    return secs


def ptxas_usage(log):
    """Registers, static shared memory per block, stack frame and spill bytes
    of every kernel in an nvcc -Xptxas -v log, by demangled name."""
    import re

    usage, fn = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = dict(registers=0, smem=0, stack=0, spill=0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and fn:
            usage[fn]["stack"], usage[fn]["spill"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            usage[fn]["smem"] = int(sm.group(1)) if sm else 0
    names = list(usage)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.split("\n")[:len(names)]
    except (OSError, subprocess.CalledProcessError):
        pass
    names = [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
             for n in names]
    return dict(zip(names, usage.values()))


def phase_kernels(torch):
    import torch.nn.functional as F

    from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
    from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_plain,
                                       upfirdn2d, upfirdn2d_plain)
    from s2v_torch.ops.kernels.upfirdn2d import stuff_and_pad

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def tol(dtype, ref):
        scale = max(1.0, ref.abs().max().item())
        return (1e-5 if dtype == torch.float32 else 1e-2) * scale

    # K1: the last generator level of GPEN-2048 ([1, 32, 2048, 2048]) and a
    # ragged shape that takes the scalar path
    for shape in ((1, 32, 2048, 2048), (3, 37, 33, 29)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            b = torch.randn(shape[1], generator=g, device=dev)
            got = fused_bias_leaky_relu(x, b)
            want = fused_bias_leaky_relu_plain(x, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            n = x.numel()
            bms, by = bound_ms(2 * n * x.element_size() + 4 * shape[1], 4 * n)
            case = dict(kernel="fused_act", shape=list(shape), dtype=str(dtype)[6:],
                        max_abs_err=err, tol=tol(dtype, want),
                        ms=event_ms(torch, fused_bias_leaky_relu, (x, b)),
                        plain_ms=event_ms(torch, fused_bias_leaky_relu_plain, (x, b)),
                        bound_ms=bms, bound_by=by, library_ms=None)
            cases.append(case)
            del x, got, want

    # K3: the GPEN-2048 configurations, a down=2 case and a negative pad
    blur = make_kernel(BLUR_TAPS)
    k3 = [((1, 16, 2049, 2049), 1, 1, (1, 1), blur * 4),  # after each transposed conv
          ((1, 16, 2048, 2048), 1, 1, (2, 2), blur),      # before a stride-2 encoder conv
          ((1, 3, 1024, 1024), 2, 1, (2, 1), blur * 4),   # ToRGB skip upsample
          ((1, 16, 2048, 2048), 1, 2, (1, 1), blur),      # StyleGAN2 downsample
          ((1, 16, 1024, 1024), 1, 1, (-1, 2), blur),     # negative pad crops
          ((1, 512, 9, 9), 1, 1, (1, 1), blur * 4)]        # after the first transposed conv
    for shape, up, down, pad, fir in k3:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            got = upfirdn2d(x, fir, up, down, pad)
            want = upfirdn2d_plain(x, fir, up, down, pad)
            torch.cuda.synchronize()
            err = (math.inf if got.shape != want.shape
                   else (got.float() - want.float()).abs().max().item())
            taps = fir.size / (up * up)  # taps that meet a nonzero sample
            bms, by = bound_ms((x.numel() + got.numel()) * x.element_size(),
                               2 * taps * got.numel())
            xp = stuff_and_pad(x, up, pad)
            w = torch.flip(torch.as_tensor(fir, device=dev), (0, 1)).to(dtype)
            w = w[None, None].repeat(shape[1], 1, 1, 1)
            case = dict(kernel="upfirdn2d", shape=list(shape), up=up, down=down,
                        pad=list(pad), dtype=str(dtype)[6:], max_abs_err=err,
                        tol=tol(dtype, want),
                        ms=event_ms(torch, lambda x: upfirdn2d(x, fir, up, down, pad), (x,)),
                        plain_ms=event_ms(torch, lambda x: upfirdn2d_plain(x, fir, up, down, pad),
                                          (x,)),
                        bound_ms=bms, bound_by=by,
                        library_ms=event_ms(torch, lambda xp, w: F.conv2d(
                            xp, w, stride=down, groups=shape[1]), (xp, w)))
            cases.append(case)
            del x, xp, got, want

    cases += train_kernel_cases(torch, g, tol)
    cases += gfpgan_kernel_cases(torch, g, tol)
    cases += gfpgan_v1_kernel_cases(torch, g, tol)

    for c in cases:
        ok = c["max_abs_err"] <= c["tol"]
        extra = (f" up={c['up']} down={c['down']} pad={tuple(c['pad'])}"
                 + (f" pad_x={tuple(c['pad_x'])}" if "pad_x" in c else "")
                 if c["kernel"] == "upfirdn2d" else "")
        if c["kernel"] == "fused_act_bwd":
            extra = " with b" if c["with_b"] else " no b"
        lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        c["bound_share"] = c["bound_ms"] / c["ms"]
        print(f"kernel {c['kernel']} {tuple(c['shape'])} {c['dtype']}{extra}: "
              f"max_abs_err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
              f"{'ok' if ok else 'FAIL'}; ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
              f"library {lib} bound {c['bound_ms']:.4f} ({c['bound_by']}), "
              f"{100 * c['bound_share']:.0f}% of bound")
        if not ok:
            fail(f"{c['kernel']} {c['shape']} {c['dtype']} disagrees with its plain version")
    return cases


def train_kernel_cases(torch, g, tol):
    """K1 at the training path's largest activation, K2 at that shape, at a
    ragged one and at a [B, C] one, with and without b, and K3's GPEN-512
    forward configurations with their backward (gradient) configurations."""
    from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
    from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_bwd,
                                       fused_bias_leaky_relu_bwd_plain,
                                       fused_bias_leaky_relu_plain)

    dev = torch.device("cuda")
    cases = []
    big = (4, 128, 512, 512)  # the last StyledConv after its noise concat
    x = torch.randn(big, generator=g, device=dev)
    b = torch.randn(big[1], generator=g, device=dev)
    want = fused_bias_leaky_relu_plain(x, b)
    err = (fused_bias_leaky_relu(x, b) - want).abs().max().item()
    n = x.numel()
    bms, by = bound_ms(2 * n * 4 + 4 * big[1], 4 * n)
    cases.append(dict(kernel="fused_act", shape=list(big), dtype="float32", max_abs_err=err,
                      tol=tol(torch.float32, want),
                      ms=event_ms(torch, fused_bias_leaky_relu, (x, b)),
                      plain_ms=event_ms(torch, fused_bias_leaky_relu_plain, (x, b)),
                      bound_ms=bms, bound_by=by, library_ms=None, path="train"))
    del x, want

    for shape in (big, (3, 37, 33, 29), (4, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            for with_b in (False, True):
                gr = torch.randn(shape, generator=g, device=dev).to(dtype)
                out = torch.randn(shape, generator=g, device=dev).to(dtype)
                bb = torch.randn(shape[1], generator=g, device=dev) if with_b else None
                got = fused_bias_leaky_relu_bwd(gr, out, bb)
                want = fused_bias_leaky_relu_bwd_plain(gr, out, bb)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                n = gr.numel()
                # reads g and out, writes dx (and b); add, compare, multiply
                bms, by = bound_ms(3 * n * gr.element_size() + (4 * shape[1] if with_b else 0),
                                   (3 if with_b else 2) * n)
                cases.append(dict(
                    kernel="fused_act_bwd", shape=list(shape), dtype=str(dtype)[6:],
                    with_b=with_b, max_abs_err=err, tol=tol(dtype, want),
                    ms=event_ms(torch, fused_bias_leaky_relu_bwd, (gr, out, bb)),
                    plain_ms=event_ms(torch, fused_bias_leaky_relu_bwd_plain, (gr, out, bb)),
                    bound_ms=bms, bound_by=by, library_ms=None, path="train"))
                del gr, out, got, want

    blur = make_kernel(BLUR_TAPS)
    fwd = [((4, 64, 513, 513), 1, 1, (1, 1), blur * 4),  # after the last transposed conv
           ((4, 64, 512, 512), 1, 1, (2, 2), blur),      # before a stride-2 3x3 conv
           ((4, 64, 512, 512), 1, 1, (1, 1), blur),      # D's skip, before a stride-2 1x1
           ((4, 3, 256, 256), 2, 1, (2, 1), blur * 4)]   # ToRGB skip upsample
    return cases + k3_cases(torch, g, tol, fwd, "train")


def gfpgan_kernel_cases(torch, g, tol):
    """K1, K2 and K3 at the component discriminators' shapes in GFPGAN
    training (batch 3, f32): K1 and K2 at the mouth crop's conv1 output
    [3, 64, 120, 120], K3's blur before conv2 there (121 output columns)
    and before the eye crops' conv4 ([3, 128, 40, 40], 41 columns), each
    with its backward configuration (120 and 40 columns): planes around
    the 40-column line where K3's strips take over from its one thread per
    output."""
    from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
    from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_bwd,
                                       fused_bias_leaky_relu_bwd_plain,
                                       fused_bias_leaky_relu_plain)

    dev = torch.device("cuda")
    shape = (3, 64, 120, 120)
    x = torch.randn(shape, generator=g, device=dev)
    b = torch.randn(shape[1], generator=g, device=dev)
    out = torch.randn(shape, generator=g, device=dev)
    n = x.numel()
    cases = []
    for name, fn, plain, args, nbytes, ops in (
            ("fused_act", fused_bias_leaky_relu, fused_bias_leaky_relu_plain, (x, b),
             2 * n * 4 + 4 * shape[1], 4 * n),
            ("fused_act_bwd", fused_bias_leaky_relu_bwd, fused_bias_leaky_relu_bwd_plain,
             (x, out, None), 3 * n * 4, 2 * n)):
        want = plain(*args)
        err = (fn(*args) - want).abs().max().item()
        bms, by = bound_ms(nbytes, ops)
        case = dict(kernel=name, shape=list(shape), dtype="float32", max_abs_err=err,
                    tol=tol(torch.float32, want), ms=event_ms(torch, fn, args),
                    plain_ms=event_ms(torch, plain, args), bound_ms=bms, bound_by=by,
                    library_ms=None, path="gfpgan")
        if name == "fused_act_bwd":
            case["with_b"] = False
        cases.append(case)
    del x, out, want
    blur = make_kernel(BLUR_TAPS)
    fwd = [(shape, 1, 1, (2, 2), blur),                # the mouth crop's conv2 blur
           ((3, 128, 40, 40), 1, 1, (2, 2), blur)]     # the eye crops' conv4 blur
    return cases + k3_cases(torch, g, tol, fwd, "gfpgan")


def gfpgan_v1_kernel_cases(torch, g, tol):
    """K1 and K3 in bf16 at the largest shapes GFPGANv1(512) gives them in
    the mouth tail (the original arch, opt-in phase 15; the chain's batch
    of 7 frames under bf16 autocast): K1 after the last StyleConv
    [7, 32, 512, 512], K3 after the last transposed conv [7, 32, 513, 513]
    (pad (1, 1)), before the U-Net's first stride-2 conv [7, 16, 512, 512]
    (pad (2, 2)) and the last ToRGB skip upsample [7, 3, 256, 256]."""
    import torch.nn.functional as F

    from s2v_torch.models.gpen import BLUR_TAPS, make_kernel
    from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_plain,
                                       upfirdn2d, upfirdn2d_plain)
    from s2v_torch.ops.kernels.upfirdn2d import stuff_and_pad

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    shape = (7, 32, 512, 512)
    x = torch.randn(shape, generator=g, device=dev).to(bf16)
    b = torch.randn(shape[1], generator=g, device=dev)
    want = fused_bias_leaky_relu_plain(x, b)
    err = (fused_bias_leaky_relu(x, b).float() - want.float()).abs().max().item()
    n = x.numel()
    bms, by = bound_ms(2 * n * 2 + 4 * shape[1], 4 * n)
    cases = [dict(kernel="fused_act", shape=list(shape), dtype="bfloat16", max_abs_err=err,
                  tol=tol(bf16, want), ms=event_ms(torch, fused_bias_leaky_relu, (x, b)),
                  plain_ms=event_ms(torch, fused_bias_leaky_relu_plain, (x, b)),
                  bound_ms=bms, bound_by=by, library_ms=None, path="infer_options")]
    del x, want
    blur = make_kernel(BLUR_TAPS)
    for shape, up, down, pad, fir in (((7, 32, 513, 513), 1, 1, (1, 1), blur * 4),
                                      ((7, 16, 512, 512), 1, 1, (2, 2), blur),
                                      ((7, 3, 256, 256), 2, 1, (2, 1), blur * 4)):
        x = torch.randn(shape, generator=g, device=dev).to(bf16)
        got = upfirdn2d(x, fir, up, down, pad)
        want = upfirdn2d_plain(x, fir, up, down, pad)
        err = (math.inf if got.shape != want.shape
               else (got.float() - want.float()).abs().max().item())
        bms, by = bound_ms((x.numel() + got.numel()) * 2, 2 * fir.size / (up * up) * got.numel())
        xp = stuff_and_pad(x, up, pad)
        w = torch.flip(torch.as_tensor(fir, device=dev), (0, 1)).to(bf16)[None, None].repeat(
            shape[1], 1, 1, 1)
        cases.append(dict(
            kernel="upfirdn2d", shape=list(shape), up=up, down=down, pad=list(pad),
            dtype="bfloat16", max_abs_err=err, tol=tol(bf16, want), path="infer_options",
            ms=event_ms(torch, lambda x: upfirdn2d(x, fir, up, down, pad), (x,)),
            plain_ms=event_ms(torch, lambda x: upfirdn2d_plain(x, fir, up, down, pad), (x,)),
            bound_ms=bms, bound_by=by,
            library_ms=event_ms(torch, lambda xp, w: F.conv2d(xp, w, stride=down,
                                                              groups=shape[1]), (xp, w))))
        del x, xp, got, want
    return cases


def k3_cases(torch, g, tol, fwd, path):
    """K3 in f32 at each (shape, up, down, pad, FIR) of ``fwd`` and at its
    backward (gradient) configuration, against the plain version, with
    the depthwise ``F.conv2d`` library time."""
    import torch.nn.functional as F

    from s2v_torch.ops.kernels import upfirdn2d_plain
    from s2v_torch.ops.kernels.upfirdn2d import (grad_pad, out_size, stuff_and_pad,
                                                 upfirdn2d_fwd)

    dev = torch.device("cuda")
    cases, configs = [], []
    for shape, up, down, pad, fir in fwd:
        configs.append((shape, fir, up, down, pad, pad, "forward"))
        o = out_size(shape[2], fir.shape[0], up, down, pad)
        gp = grad_pad(shape[2], o, fir.shape[0], up, down, pad)
        configs.append(((shape[0], shape[1], o, o), np.ascontiguousarray(fir[::-1, ::-1]),
                        down, up, gp, gp, "backward"))
    for shape, fir, up, down, py, px, role in configs:
        x = torch.randn(shape, generator=g, device=dev)
        got = upfirdn2d_fwd(x, fir, up, down, py, px)
        want = upfirdn2d_plain(x, fir, up, down, py, px)
        torch.cuda.synchronize()
        err = (math.inf if got.shape != want.shape
               else (got - want).abs().max().item())
        bms, by = bound_ms((x.numel() + got.numel()) * 4, 2 * fir.size / (up * up) * got.numel())
        xp = stuff_and_pad(x, up, py, px)
        w = torch.flip(torch.as_tensor(fir, device=dev), (0, 1))[None, None].repeat(
            shape[1], 1, 1, 1)
        cases.append(dict(
            kernel="upfirdn2d", shape=list(shape), up=up, down=down, pad=list(py),
            pad_x=list(px), dtype="float32", role=role, max_abs_err=err,
            tol=tol(torch.float32, want),
            ms=event_ms(torch, lambda x: upfirdn2d_fwd(x, fir, up, down, py, px), (x,)),
            plain_ms=event_ms(torch, lambda x: upfirdn2d_plain(x, fir, up, down, py, px), (x,)),
            bound_ms=bms, bound_by=by, path=path,
            library_ms=event_ms(torch, lambda xp, w: F.conv2d(xp, w, stride=down,
                                                              groups=shape[1]), (xp, w))))
        del x, xp, got, want
    return cases


def with_face_logit(torch, retina, bias):
    """Random RetinaFace weights score every anchor near 0.5, under the 0.9
    threshold: the face logit of the level-2 anchors (``ClassHead.2``
    channels 1 and 3, the class pairs sit per anchor; boxes of 256 and 512
    px) is raised by ``bias`` and that head's weights scaled by 10, so the
    anchors' logits spread apart and the argmax has a margin."""
    with torch.no_grad():
        head = retina.ClassHead[2].conv1x1
        head.weight *= 10.0
        head.bias[[1, 3]] += bias
    return retina


def with_face_landmarks(torch, retina, span=2.0):
    """Random landmark heads put a face's 5 points within a few pixels of
    each other, and the warps they set restore a speck of the frame
    (RetinaFace's speck, not where S3FD's box put the ENet paste). Level
    2's landmark head is set to place every anchor's points where the
    facexlib template has them, in a square ``span`` times the anchor's
    size (weights zeroed, biases the template's offsets from its centre
    over the decode's 0.1 variance), and its 512-px anchors' face logit is
    raised by 2 over the 256-px ones': the face crops of Step 5, the mouth
    tail and the final stage then span 1024 px, the whole of a 512^2
    frame, wherever the argmax lands."""
    from s2v_torch.pipeline.restoration import FACEXLIB_TEMPLATE_512

    offsets = (FACEXLIB_TEMPLATE_512 - 256.0) / 512.0 * span / 0.1  # [5, 2]
    with torch.no_grad():
        head = retina.LandmarkHead[2].conv1x1
        head.weight.zero_()
        head.bias.copy_(torch.from_numpy(np.tile(offsets.reshape(-1), 2)))
        retina.ClassHead[2].conv1x1.bias[3] += 2.0
    return retina


def with_live_landmarks(torch, retina, seed=5, input_scale=0.05, span=0.5):
    """A slim RetinaFace whose landmarks come from live features, so that
    bf16 convs move them: the default init shrinks the activations about
    1e5-fold by level 2, where the heads then read their biases alone. The
    body's, FPN's and SSHs' convs get He-normal weights from ``seed`` (the
    first scaled by ``input_scale``, for pixel inputs), so every level's
    features stay of order 0.1-1. The level-2 face logit rests on its
    bias (``ClassHead.2`` weights zeroed: every level-2 anchor ties, in f32
    and in bf16 alike, and the first wins on either device), and
    ``LandmarkHead.2`` keeps its random weights over biases that place the
    facexlib template in a square ``span`` times the anchor, as
    ``with_face_landmarks`` does: the points keep a face's layout, and the
    features move them by a few pixels."""
    from s2v_torch.pipeline.restoration import FACEXLIB_TEMPLATE_512

    g = torch.Generator().manual_seed(seed)
    convs = [m for part in (retina.body, retina.fpn, retina.ssh1, retina.ssh2, retina.ssh3)
             for m in part.modules() if isinstance(m, torch.nn.Conv2d)]
    offsets = (FACEXLIB_TEMPLATE_512 - 256.0) / 512.0 * span / 0.1
    with torch.no_grad():
        for m in convs:
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * math.sqrt(2.0 / m.weight[0].numel()))
        convs[0].weight *= input_scale
        retina.ClassHead[2].conv1x1.weight.zero_()
        retina.LandmarkHead[2].conv1x1.bias.copy_(
            torch.from_numpy(np.tile(offsets.reshape(-1), 2)))
    return retina


MOUTH_CLASS = 11  # the upper lip: 255 in the face and in the mouth colormap


def with_face_mask(torch, parsenet, bias=1.0):
    """Random ParseNet logits vary by about 0.2 and mostly pick classes the
    colormaps map to 0, so the enhancers would paste little and the mouth
    tail nothing: class 11's logit is raised by ``bias``, and the whole crop
    is face and mouth."""
    with torch.no_grad():
        parsenet.out_mask_conv.conv2d.bias[MOUTH_CLASS] += bias
    return parsenet


def with_unsaturated_rgb(torch, gfpgan, scale=0.25):
    """GFPGAN with its ToRGB layers scaled by ``scale``: random weights put
    part of the output outside [-1, 1], the restored face is then exact 0s
    and 255s there, and a paste of those lands on integers, where the last
    f32 bit decides the uint8 truncation on each device."""
    from s2v_torch.models.layers import ToRGB

    with torch.no_grad():
        for module in gfpgan.modules():
            if isinstance(module, ToRGB):
                module.modulated_conv.weight *= scale
                module.bias *= scale
    return gfpgan


def slim_models(torch):
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.gfpgan import GFPGANv1Clean
    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.models.retinaface import retinaface_mnet
    from s2v_torch.models.rrdbnet import RRDBNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        return dict(enet=ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
                              lnet_base_nc=8, lnet_max_nc=32),
                    facegan=FullGenerator(size=64, narrow=0.25, channel_multiplier=0.5,
                                          style_dim=64, n_mlp=2),
                    parsenet=with_face_mask(torch, ParseNet(base_ch=16, max_ch=32, min_ch=8,
                                                            res_depth=2)),
                    srmodel=RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8),
                    retinaface=with_face_logit(torch, retinaface_mnet(), 4.0),
                    gfpgan=with_unsaturated_rgb(torch, GFPGANv1Clean(
                        out_size=64, num_style_feat=64, channel_multiplier=0.5, narrow=0.5)))


def full_models(torch):
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.gfpgan import GFPGANv1Clean
    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.models.retinaface import RetinaFace
    from s2v_torch.models.rrdbnet import RRDBNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return dict(enet=ENet(), facegan=FullGenerator(size=2048),
                    parsenet=with_face_mask(torch, ParseNet()),
                    srmodel=RRDBNet(scale=2, num_feat=32, num_block=23, num_grow_ch=32),
                    retinaface=with_face_landmarks(torch, with_face_logit(torch, RetinaFace(),
                                                                          4.0)),
                    gfpgan=GFPGANv1Clean())  # GFPGANv1.4's geometry


def make_pipeline(models, in_size, dtype, parse_size, device, batch=16, steps=None,
                  reuse=True, mouth=False):
    """The Step 6 pipeline with the final hook; ``steps`` adds the Step 1-3
    models (with the synthetic lm3d and a zero expression). With ``reuse``
    the final stage takes the Step-1 landmarks (model.reuse_detections);
    without, the pipeline runs the default configuration: RetinaFace in the
    final stage and Step 5 (GPEN-BFR-512's enhancer at 512^2 with
    face_enhance=False, which runs no GPEN and so is built without one,
    sharing RetinaFace and ParseNet with the final stage as cli.py does).
    With ``mouth`` the mouth tail runs before the final stage (GFPGANv1Clean
    at 512, sharing RetinaFace and ParseNet too). Returns (pipeline, final
    hook, final enhancer, Step-5 enhancer or None, mouth hook or None)."""
    from s2v_torch.pipeline.restoration import make_mouth_restorer
    from s2v_torch.pipeline.enhance import (FaceEnhancer, final_enhancer_hook,
                                            reference_enhancer_hook)
    from s2v_torch.pipeline.inference import LipSyncPipeline, PipelineModels
    from s2v_torch.utils.config import InferenceConfig, ModelConfig, PipelineConfig

    names = ("facegan", "parsenet", "srmodel") + (() if reuse else ("retinaface",))
    final = FaceEnhancer({k: models[k] for k in names}, in_size=in_size, dtype=dtype,
                         parse_size=parse_size, device=device)
    ref = None if reuse else FaceEnhancer(
        {k: models[k] for k in ("retinaface", "parsenet")}, in_size=512, dtype=dtype,
        parse_size=parse_size, device=device)
    cfg = PipelineConfig(model=ModelConfig(dtype=dtype, reuse_detections=reuse),
                         infer=InferenceConfig(lnet_batch_size=batch))
    hook = final_enhancer_hook(final)
    extra = {} if steps is None else dict(steps, lm3d=LM3D, expression=np.zeros(64, np.float32))
    if ref is not None:
        extra["ref_enhancer"] = reference_enhancer_hook(ref)
    tail = None
    if mouth:
        tail = extra["mouth_restorer"] = make_mouth_restorer(
            {k: models[k] for k in ("retinaface", "gfpgan", "parsenet")}, parse_size=parse_size,
            dtype=dtype, device=device)
    pipe = LipSyncPipeline(cfg, PipelineModels(enet=models["enet"], final_enhancer=hook,
                                               **extra), device=device)
    return pipe, hook, final, ref, tail


# a synthetic 5-point lm3d (the BFM file is not in the repo), as
# tests/test_pipeline_e2e.py uses
LM3D = np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                   [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float64)


def steps_models(torch, slim, face_bias):
    """S3FD and FAN (2DFAN4) at full width, ReconNet and DNet slim or at
    full width, random weights from a fixed seed; the face-class bias of
    S3FD's stride-4 head raised by ``face_bias`` so every frame has a box."""
    from s2v_torch.models.dnet import DNet
    from s2v_torch.models.fan import FAN
    from s2v_torch.models.resnet import ReconNet
    from s2v_torch.models.s3fd import S3FD

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3 if slim else 0)
        models = dict(s3fd=S3FD(), fan=FAN(),
                      recon=ReconNet(layers=(1, 1, 1, 1), base_planes=8) if slim else ReconNet(),
                      dnet=DNet(16, 8, 8, 32) if slim else DNet())
    with torch.no_grad():
        models["s3fd"].conv3_3_norm_mbox_conf.bias[3] += face_bias
    return models


def clip_inputs(n, h, w, seconds, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
    frames = np.clip(base[None] + rng.randn(n, h, w, 3) * 20, 0, 255).astype(np.uint8)
    stab = (rng.rand(n, 256, 256, 3) * 255).astype(np.uint8)
    cx, cy, s = w / 2, h / 2, min(h, w) * 0.3
    boxes = np.tile(np.asarray([cx - s, cy - s, cx + s, cy + s], np.float32), (n, 1))
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = (0.5 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.01 * rng.randn(len(t))).astype(np.float32)
    return dict(frames=frames, stab=stab, boxes=boxes, wav=wav,
                coords=(h // 8, h - h // 8, w // 8, w - w // 8),
                lms_full=synthetic_landmarks(n, h, w, rng),
                lms_stab=synthetic_landmarks(n, 256, 256, rng))


def run_slice(torch, pipe, x, device):
    from s2v_torch.audio import melspectrogram

    mel = melspectrogram(torch.from_numpy(x["wav"]).to(device))
    return pipe.synthesize(x["stab"], mel, x["frames"], x["coords"], 25.0,
                           boxes_full=x["boxes"], lms_full=x["lms_full"],
                           lms_stab=x["lms_stab"])


def phase_reference(torch):
    """Slim slice on the card (kernels) against the CPU (plain versions)."""
    models = slim_models(torch)
    x = clip_inputs(6, 96, 112, 0.35, seed=3)
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = make_pipeline(copy.deepcopy(models), 64, "float32", 128, device, batch=4)[0]
        outs[device] = run_slice(torch, pipe, x, device)
    return frames_agree("reference: slim slice card vs CPU", outs["cuda"], outs["cpu"],
                        (6, 192, 224, 3))


def frames_agree(what, got, want, shape):
    """uint8 frames within one gray level: at most 0.1% of subpixels off by
    more than 1, a mean difference under 0.01, the expected shape."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d > 1).mean())
    ok = got.shape == shape and share <= 1e-3 and d.mean() < 0.01
    print(f"{what}, output {got.shape}: max diff {d.max()}, share > 1 gray level "
          f"{share:.2e} (tol 1e-3), mean {d.mean():.4f} (tol 0.01) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: the card disagrees with the CPU")
    return dict(max_diff=int(d.max()), share_over_1=share, mean=float(d.mean()))


def record_valid(enhancer, sink):
    """Wrap ``enhancer._detect`` (a FaceEnhancer's or a GFPGANRestorer's:
    the valid flags come last) so each call's input and valid flags land in
    ``sink`` (on the device: reading them here would synchronise)."""
    detect = enhancer._detect

    def run(x):
        out = detect(x)
        sink.append((x, out[-1]))
        return out

    enhancer._detect = run


def valid_count(sink):
    return int(sum(int(v.sum()) for _, v in sink)), int(sum(len(v) for _, v in sink))


def retina_outputs(torch, model, frames, dev):
    """RetinaFace on RGB uint8 frames as the enhancer feeds it, f32 without
    TF32; (network outputs, detect_faces) on the host."""
    from s2v_torch.device import full_f32
    from s2v_torch.models.retinaface import RETINA_MEAN, detect_faces

    x = torch.as_tensor(frames, device=dev).permute(0, 3, 1, 2).float()
    mean = torch.tensor(RETINA_MEAN, device=dev).view(1, 3, 1, 1)
    with torch.no_grad(), full_f32():
        outs = model.to(dev)(x.flip(1) - mean)
        det = detect_faces(outs, frames.shape[1:3])
    return [o.cpu() for o in outs], [d.cpu() for d in det]


def phase_retina_reference(torch):
    """RetinaFace-R50 at full width on the card against the CPU, f32, on two
    256^2 frames (Step 5's size) and one 1024^2 frame (the final stage's):
    loc, conf and landms within 1e-4 of their scale; the best box and
    landmarks where the top-2 margin of the face score exceeds twice the
    measured score difference (every frame must qualify), every frame
    valid. Then the slim Step-5 enhancer and the slim final hook without
    landmarks (RetinaFace cfg_mnet detecting), card vs CPU, every frame
    valid."""
    from s2v_torch.models.retinaface import RetinaFace
    from s2v_torch.pipeline.enhance import (FaceEnhancer, final_enhancer_hook,
                                            reference_enhancer_hook)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        retina = with_face_logit(torch, RetinaFace(), 4.0).eval()
    res = {}
    for size, n in ((256, 2), (1024, 1)):
        frames = clip_inputs(n, size, size, 0.1, seed=5)["frames"]
        (cpu, cpu_det), (card, card_det) = [retina_outputs(torch, retina, frames, d)
                                            for d in ("cpu", "cuda")]
        rel = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(card, cpu))
        top = cpu[1][..., 1].topk(2, dim=1).values
        score_diff = (card[1][..., 1] - cpu[1][..., 1]).abs().max().item()
        held = ((top[:, 0] - top[:, 1]) > 2 * score_diff).numpy()
        box_px = (card_det[0] - cpu_det[0]).abs()[held].max().item() if held.any() else 0.0
        lm_px = (card_det[1] - cpu_det[1]).abs()[held].max().item() if held.any() else 0.0
        valid = int(card_det[2].sum()), int(cpu_det[2].sum())
        ok = (rel <= 1e-4 and held.all() and box_px <= 1e-2 and lm_px <= 5e-2
              and valid == (n, n))
        print(f"retina reference: RetinaFace-R50 {n}x{size}^2 card vs CPU, f32: outputs "
              f"{rel:.2e} of scale (tol 1e-4); score diff {score_diff:.1e}, top-2 margins "
              f"{', '.join(f'{m:.1e}' for m in (top[:, 0] - top[:, 1]).tolist())}; boxes "
              f"{box_px:.2e} px (tol 1e-2), landmarks {lm_px:.2e} px (tol 5e-2) over "
              f"{int(held.sum())}/{n} frames; valid card {valid[0]}/{n}, CPU {valid[1]}/{n} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"retina reference: RetinaFace-R50 at {size}^2 on the card disagrees with the CPU")
        res[size] = dict(outputs_rel=rel, score_diff=score_diff, held=int(held.sum()),
                         box_px=box_px, lm_px=lm_px, valid=valid)

    models = slim_models(torch)
    stab = clip_inputs(4, 256, 256, 0.1, seed=6)["frames"]
    x = clip_inputs(4, 96, 112, 0.1, seed=7)
    outs, valid = {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(models)
        ref = FaceEnhancer({k: m[k] for k in ("retinaface", "parsenet")}, in_size=64,
                           dtype="float32", parse_size=128, device=dev)
        final = FaceEnhancer({k: m[k] for k in ("retinaface", "facegan", "parsenet", "srmodel")},
                             in_size=64, dtype="float32", parse_size=128, device=dev)
        valid[dev] = ([], [])
        record_valid(ref, valid[dev][0])
        record_valid(final, valid[dev][1])
        outs[dev] = (reference_enhancer_hook(ref)(stab).cpu().numpy(),
                     final_enhancer_hook(final)(x["frames"], x["boxes"]).cpu().numpy())
    for i, (what, shape) in enumerate((("Step-5 enhancer", (4, 256, 256, 3)),
                                       ("final hook, no landmarks", (4, 192, 224, 3)))):
        counts = [valid_count(valid[d][i])[0] for d in ("cuda", "cpu")]
        res[what] = dict(frames_agree(f"retina reference: slim {what} card vs CPU "
                                      f"(valid card {counts[0]}/4, CPU {counts[1]}/4)",
                                      outs["cuda"][i], outs["cpu"][i], shape), valid=counts)
        if counts != [4, 4]:
            fail(f"retina reference: slim {what}: not every frame valid")
    return res


def mouth_checks(torch, parsenet, restored, frames, out, boxes, parse_size):
    """The mouth mask's coverage of the boxes (ParseNet on the restored face
    boxes, as the tail parses them) and the tail's mean change inside the
    boxes, in gray levels. restored, frames, out [k, 3, H, W] or [k, H, W, 3]
    uint8 tensors on one device; boxes [k, 4] x1y1x2y2."""
    from s2v_torch.device import full_f32
    from s2v_torch.models.parsenet import MOUTH_COLORMAP, parse_mask
    from s2v_torch.ops.warp import crop_resize_boxes

    def nchw(t):
        t = torch.as_tensor(t)
        return (t if t.shape[1] == 3 else t.permute(0, 3, 1, 2)).float()

    restored, frames, out = nchw(restored), nchw(frames), nchw(out)
    bx = torch.as_tensor(np.asarray(boxes, np.float32), device=restored.device)
    with torch.no_grad(), full_f32():
        crop = crop_resize_boxes(restored, bx, (parse_size, parse_size))
        logits, _ = parsenet(crop / 255.0 * 2.0 - 1.0)
    coverage = float((parse_mask(logits.float(), MOUTH_COLORMAP) > 0).float().mean())
    change = []
    for k, (x1, y1, x2, y2) in enumerate(np.asarray(boxes).astype(int)):
        change.append(float((out[k, :, y1:y2, x1:x2] - frames[k, :, y1:y2, x1:x2]).abs().mean()))
    return coverage, float(np.mean(change))


def phase_mouth_reference(torch, card):
    """The mouth tail at slim widths on the card against the CPU, f32: the
    hook detecting and with landmarks5, the non-SR possion composite, every
    face valid, the mask covering the boxes and the boxes changed; then the
    10-level blend at 512^2 on both, and its device ms on the card at the
    chain's batch of 7."""
    from s2v_torch.models.fan import lm68_to_lm5
    from s2v_torch.pipeline.enhance import FaceEnhancer
    from s2v_torch.pipeline.restoration import make_mouth_restorer
    from s2v_torch.pipeline.utils import laplacian_pyramid_blend

    models = slim_models(torch)
    x = clip_inputs(4, 96, 112, 0.1, seed=8)
    frames, boxes = x["frames"], x["boxes"]
    lm5 = lm68_to_lm5(x["lms_full"]).astype(np.float32)
    outs, valid, checks = {}, {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(models)
        hook = make_mouth_restorer({k: m[k] for k in ("retinaface", "gfpgan", "parsenet")},
                                   chunk=4, parse_size=128, dtype="float32", device=dev)
        enh = FaceEnhancer({k: m[k] for k in ("retinaface", "facegan", "parsenet")}, in_size=64,
                           dtype="float32", parse_size=128, device=dev)
        sinks = ([], [])
        record_valid(hook.restorer, sinks[0])
        record_valid(enh, sinks[1])
        detected = hook(frames, boxes)
        supplied = hook(frames, boxes, landmarks5=lm5)  # runs no detector
        possion = enh.process_batch(frames, face_enhance=True, possion_blending=True,
                                    bboxes=boxes[:, [1, 3, 0, 2]])
        valid[dev] = [valid_count(sink)[0] for sink in sinks]
        checks[dev] = [mouth_checks(torch, hook.parsenet, hook.restorer.enhance_batch(frames, **kw),
                                    torch.as_tensor(frames, device=dev), out, boxes, 128)
                       for out, kw in ((detected, {}), (supplied, {"landmarks5": lm5}))]
        outs[dev] = [t.cpu().numpy() for t in (detected, supplied, possion)]
    res = {}
    for i, what in enumerate(("hook detecting", "hook with landmarks5", "possion composite")):
        counts = [valid[d][1 if i == 2 else 0] for d in ("cuda", "cpu")]
        label = ("no detector" if i == 1 else
                 f"valid card {counts[0]}/4, CPU {counts[1]}/4")
        res[what] = dict(frames_agree(f"mouth reference: slim {what} card vs CPU ({label})",
                                      outs["cuda"][i], outs["cpu"][i], (4, 96, 112, 3)))
        if i != 1:
            res[what]["valid"] = counts
            if counts != [4, 4]:
                fail(f"mouth reference: slim {what}: not every frame valid")
        if i < 2:
            coverage, change = checks["cuda"][i]
            res[what].update(mask_coverage=coverage, box_change=change)
            print(f"  mouth mask covers {100 * coverage:.1f}% of the boxes (want > 99%); "
                  f"mean change in the boxes {change:.1f} gray levels (want > 5)")
            if not (coverage > 0.99 and change > 5.0):
                fail(f"mouth reference: slim {what}: the mask or the tail did nothing")

    rng = np.random.RandomState(9)
    a, b = [torch.from_numpy((rng.rand(7, 3, 512, 512) * 255).astype(np.float32))
            for _ in range(2)]
    mask = torch.from_numpy(rng.rand(7, 1, 512, 512).astype(np.float32))
    want = laplacian_pyramid_blend(a, b, mask, 10)
    args = [t.cuda() for t in (a, b, mask)]
    got = laplacian_pyramid_blend(*args, 10)
    err = (got.cpu() - want).abs().max().item()
    ms = event_ms(torch, lambda: laplacian_pyramid_blend(*args, 10))
    ok = err <= 1e-3
    print(f"mouth reference: laplacian_pyramid_blend [7, 3, 512, 512], 10 levels, card vs CPU: "
          f"max abs err {err:.2e} (tol 1e-3, 0..255) {'ok' if ok else 'FAIL'}; "
          f"{ms:.3f} ms on the card for the batch ({ms / 7:.3f} a frame); {card}")
    if not ok:
        fail("mouth reference: laplacian_pyramid_blend on the card disagrees with the CPU")
    res["blend"] = dict(max_abs_err=err, ms_batch7=ms)
    return res


def decode_margins(hm):
    """Per landmark of heatmaps [B, 68, h, w], the least change that could
    move its decode: the top-2 margin of the argmax and, at the argmax, the
    gaps between the neighbours that set the +-0.25 steps."""
    b, n, hh, ww = hm.shape
    flat = hm.flatten(2)
    top = flat.topk(2, dim=2)
    idx = top.indices[..., 0]
    py, px = idx // ww, idx % ww

    def at(dy, dx):
        return flat.gather(2, ((py + dy).clamp(0, hh - 1) * ww
                               + (px + dx).clamp(0, ww - 1))[..., None])[..., 0]

    gaps = (top.values[..., 0] - top.values[..., 1]).minimum(
        (at(0, 1) - at(0, -1)).abs()).minimum((at(1, 0) - at(-1, 0)).abs())
    return gaps.numpy()


def phase_steps_reference(torch):
    """Steps 1-3 on the card against the CPU from the same weights, f32;
    each card step after the first takes the CPU's output of the step
    before, so every comparison sees identical inputs. Boxes and landmarks
    are argmax decodes: each is compared where its margin exceeds twice the
    largest card-vs-CPU difference of the scores or heatmaps it decodes (no
    flip is possible there)."""
    from s2v_torch.models.fan import box_to_center_scale, crop_faces_batched
    from s2v_torch.models.s3fd import BGR_MEAN, decode_all
    from s2v_torch.pipeline.inference import LipSyncPipeline, PipelineModels
    from s2v_torch.utils.config import ModelConfig, PipelineConfig

    # +3, not +20: the scores stay below 1, so the argmax is no tie
    models = steps_models(torch, slim=True, face_bias=3.0)
    rng = np.random.RandomState(4)
    frames = clip_inputs(3, 192, 160, 0.3, seed=4)["frames"]
    first_lm = synthetic_landmarks(1, 192, 160, rng)[0]
    lm256 = synthetic_landmarks(3, 256, 256, rng)
    cfg = PipelineConfig(model=ModelConfig(dtype="float32"))
    r = {}
    for dev in ("cpu", "cuda"):
        pipe = LipSyncPipeline(cfg, PipelineModels(**copy.deepcopy(models), lm3d=LM3D,
                                                   expression=np.zeros(64, np.float32)),
                               device=dev)
        cpu = r.get("cpu", {})
        out = {}
        out["lms"], out["boxes"] = pipe.extract_landmarks(frames, return_boxes=True)
        out["f256"], out["coords"] = pipe.ffhq_crop(frames, first_lm)
        f256 = cpu.get("f256", out["f256"])
        out["sem"] = pipe.extract_coeffs(f256, lm256)
        out["stab"] = pipe.stabilize(f256, cpu.get("sem", out["sem"]))
        with torch.no_grad():  # TF32 is off for the whole run
            x = torch.as_tensor(frames, device=dev).permute(0, 3, 1, 2).float()
            mean = torch.tensor(BGR_MEAN, device=dev).view(1, 3, 1, 1)
            maps = pipe.models.s3fd(x.flip(1) - mean)
            out["maps"] = [t.cpu() for pair in maps for t in pair]
            out["scores"] = decode_all(maps)[1].cpu()
            for key, boxes in (("hm", cpu.get("boxes", out["boxes"])),  # identical inputs
                               ("hm_own", out["boxes"])):  # as extract_landmarks saw them
                centers, scales = box_to_center_scale(torch.as_tensor(boxes, device=dev))
                out[key] = pipe.models.fan(crop_faces_batched(x, centers, scales)).cpu()
        r[dev] = out
    cpu, card = r["cpu"], r["cuda"]

    def rel(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    top = cpu["scores"].topk(2, dim=1).values
    score_diff = (card["scores"] - cpu["scores"]).abs().max().item()
    box_ok = (top[:, 0] - top[:, 1]).numpy() > 2 * score_diff
    hm_diff = (card["hm_own"] - cpu["hm_own"]).abs().max().item()
    lm_ok = box_ok[:, None] & (decode_margins(cpu["hm_own"]) > 2 * hm_diff)
    res = dict(
        maps_rel=max(rel(a, b) for a, b in zip(card["maps"], cpu["maps"])),
        hm_rel=rel(card["hm"], cpu["hm"]), score_diff=score_diff, hm_diff=hm_diff,
        boxes_compared=int(box_ok.sum()), landmarks_compared_share=float(lm_ok.mean()),
        box_px=float(np.abs(card["boxes"] - cpu["boxes"])[box_ok].max(initial=0.0)),
        lm_px=float(np.abs(card["lms"] - cpu["lms"])[lm_ok].max(initial=0.0)),
        crop_levels=int(np.abs(card["f256"].astype(np.int32) - cpu["f256"]).max()),
        coeff_rel=float(np.abs(card["sem"] - cpu["sem"]).max()
                        / max(1.0, np.abs(cpu["sem"]).max())),
        coords_equal=card["coords"] == cpu["coords"])
    d = np.abs(card["stab"].astype(np.int32) - cpu["stab"].astype(np.int32))
    res.update(stab_max=int(d.max()), stab_share_over_1=float((d > 1).mean()),
               stab_mean=float(d.mean()))
    checks = {"S3FD maps": res["maps_rel"] <= 1e-4, "FAN heatmaps": res["hm_rel"] <= 1e-4,
              "boxes": res["box_px"] <= 1e-2 and res["boxes_compared"] == len(frames),
              "landmarks": res["lm_px"] <= 1e-2 and res["landmarks_compared_share"] >= 0.9,
              "FFHQ crop": res["crop_levels"] <= 1 and res["coords_equal"],
              "coefficients": res["coeff_rel"] <= 1e-4 and bool(np.isfinite(card["sem"]).all()),
              "stabilised frames": (res["stab_share_over_1"] <= 1e-3 and res["stab_mean"] < 0.01
                                    and card["stab"].shape == (3, 256, 256, 3))}
    print(f"steps reference: Steps 1-3 card vs CPU, f32, 3 frames 192x160: S3FD maps "
          f"{res['maps_rel']:.2e}, FAN heatmaps {res['hm_rel']:.2e} of scale (tol 1e-4); boxes "
          f"{res['box_px']:.2e} px over {res['boxes_compared']}/3 frames (score margin > "
          f"{2 * score_diff:.1e}), landmarks {res['lm_px']:.2e} px over "
          f"{100 * res['landmarks_compared_share']:.1f}% (heatmap margins > {2 * hm_diff:.1e}; "
          f"tol 1e-2 px, at least 90%); crops {res['crop_levels']} gray levels; coefficients "
          f"{res['coeff_rel']:.2e} (tol 1e-4); stabilised max {res['stab_max']}, share > 1 "
          f"{res['stab_share_over_1']:.2e} (tol 1e-3), mean {res['stab_mean']:.4f} (tol 0.01) "
          f"{'ok' if all(checks.values()) else 'FAIL'}")
    for name, ok in checks.items():
        if not ok:
            fail(f"steps reference: {name} on the card disagree with the CPU")
    return res


class StepClock:
    """Times the chained run's steps, summing over calls of one name:
    synchronised wall ms or, with ``profile`` (a set of step names), each of
    those steps under its own torch.profiler session (device ms and kernel
    rows); other names then pass untimed, so a profiled step may hold a
    timed one but not another profiled one."""

    def __init__(self, torch, profile=None):
        self.torch, self.profile = torch, profile
        self.ms, self.device_ms, self.rows = {}, {}, {}

    @contextlib.contextmanager
    def __call__(self, name):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if self.profile is not None and name not in self.profile:
            yield
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.profile is not None:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                yield
                torch.cuda.synchronize()
            rows = device_rows(prof)
            self.rows[name] = self.rows.get(name, []) + rows
            self.device_ms[name] = self.device_ms.get(name, 0.0) + sum(ms for _, _, ms in rows)
        else:
            yield
            torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def clock_methods(obj, clock_of, names):
    """Wrap ``obj``'s methods ``{attr: step name}`` so every call runs inside
    the step of the clock that ``clock_of()`` returns at that moment."""
    for attr, name in names.items():
        def run(*a, _fn=getattr(obj, attr), _name=name, **k):
            with clock_of()(_name):
                return _fn(*a, **k)
        setattr(obj, attr, run)


def run_chain(torch, pipe, x, clock):
    """frames -> Steps 1-3 -> Step 5 -> mel -> Step 6 with the final hook,
    the chain ``LipSyncPipeline.run`` builds in the default configuration
    (RetinaFace locates the face in Step 5 and in the final stage).
    Landmark-driven geometry (FFHQ crop, alignment, reference faces) takes
    the clip's synthetic landmarks (the random FAN's are noise). ReconNet's
    share of extract_coeffs is timed by hooks on its module."""
    from s2v_torch.audio import melspectrogram

    frames = x["frames"]
    frames_dev = torch.as_tensor(frames, device="cuda")  # the clip crosses once
    with clock("step1_sweep"):
        _, boxes = pipe.extract_landmarks(frames_dev, return_boxes=True)
    with clock("ffhq_crop"):
        f256, coords = pipe.ffhq_crop(frames, x["lms_full"][0], frames_dev=frames_dev,
                                      device_out=True)
    with clock("crop_sweep"):
        pipe.extract_landmarks(f256)
    recon_s = []

    def tick(*_):
        torch.cuda.synchronize()
        recon_s.append(time.perf_counter())

    hooks = [pipe.models.recon.register_forward_pre_hook(tick),
             pipe.models.recon.register_forward_hook(tick)]
    try:
        with clock("coeffs"):
            semantic = pipe.extract_coeffs(f256, x["lms_stab"])
    finally:
        for h in hooks:
            h.remove()
    with clock("dnet"):
        stab = pipe.stabilize(f256, semantic, device_out=True)
    with clock("step5"):
        enhanced, _ = pipe.enhance_reference(stab)
    with clock("mel"):
        mel = melspectrogram(torch.from_numpy(x["wav"]).cuda())
    with clock("synthesize"):
        out = pipe.synthesize(enhanced, mel, frames_dev, coords, 25.0, boxes_full=boxes,
                              lms_stab=x["lms_stab"])
    clock.ms["recon"] = sum(b - a for a, b in zip(recon_s[::2], recon_s[1::2])) * 1e3
    if "coeffs" in clock.ms:  # (a run that profiles other steps does not time it)
        clock.ms["host_alignment"] = clock.ms["coeffs"] - clock.ms["recon"]
    return out, dict(boxes=boxes, coords=coords, stab=stab, enhanced=enhanced, mel=mel,
                     frames_dev=frames_dev, semantic=semantic)


# the Step 1-3 parts timed per frame; "coeffs" (host alignment + ReconNet)
# is one profiled step
STEPS = ("step1_sweep", "ffhq_crop", "crop_sweep", "host_alignment", "recon", "dnet")
STEP5 = ("step5_detect", "step5_warp_parse", "step5_paste")
PROFILED = ("step1_sweep", "ffhq_crop", "crop_sweep", "coeffs", "dnet") + STEP5
# the mouth tail's parts, profiled in a run of their own (inside synthesize)
TAIL = ("mouth_detect", "mouth_restore_paste", "mouth_parse_blend")


def phase_slice(torch, card):
    from s2v_torch.audio.melspec import num_mel_chunks
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts

    t = time.perf_counter()
    models = full_models(torch)
    steps = steps_models(torch, slim=False, face_bias=20.0)
    pipe, hook, final, ref, mouth = make_pipeline(models, 2048, "bfloat16", 512, "cuda",
                                                  steps=steps, reuse=False, mouth=True)

    def mparams(m):
        return f"{sum(p.numel() for p in m.parameters()) / 1e6:.1f}M"

    print(f"slice: built full-width models in {time.perf_counter() - t:.1f} s "
          f"(S3FD {mparams(steps['s3fd'])}, FAN {mparams(steps['fan'])}, ReconNet "
          f"{mparams(steps['recon'])}, DNet {mparams(steps['dnet'])}, RetinaFace-R50 "
          f"{mparams(models['retinaface'])}, ENet {mparams(models['enet'])}, GFPGANv1Clean "
          f"{mparams(models['gfpgan'])}, GPEN-BFR-2048 "
          f"{mparams(models['facegan'])}, ParseNet {mparams(models['parsenet'])}, RRDBNet "
          f"{mparams(models['srmodel'])} params); default configuration "
          f"(reuse_detections={pipe.cfg.model.reuse_detections})")
    x = clip_inputs(8, 512, 512, 0.4, seed=0)

    stages = {"enet_batch": [], "mouth": [], "final": []}
    last = {}  # the tail's last call: its input, boxes and output; GFPGAN's restore

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[key].append((time.perf_counter() - t0) * 1e3)
            if key == "mouth":
                last.update(frames=a[0], boxes=a[1], out=out)
            return out
        return run

    def keep_restored(fn):
        def run(restored, frames, boxes):
            last["restored"] = restored
            return fn(restored, frames, boxes)
        return run

    pipe._step6 = timed(pipe._step6, "enet_batch")
    pipe.models.mouth_restorer = timed(mouth, "mouth")
    mouth._blend = keep_restored(mouth._blend)
    pipe.models.final_enhancer = timed(hook, "final")
    detect = final._detect  # the final stage's RetinaFace pass, timed alone below
    valid = {"step5": [], "mouth": [], "final": []}
    record_valid(ref, valid["step5"])
    record_valid(mouth.restorer, valid["mouth"])  # no clock inside the tail or the final
    record_valid(final, valid["final"])  # stage: no syncs
    current = {}
    clock_methods(ref, lambda: current["clock"], dict(
        _detect="step5_detect", _faces_and_masks="step5_warp_parse",
        _paste_composite="step5_paste"))

    current["clock"] = StepClock(torch)
    run_chain(torch, pipe, x, current["clock"])  # warm-up: cuDNN plans, allocator
    for v in (*stages.values(), *valid.values()):
        v.clear()
    torch.cuda.reset_peak_memory_stats()

    clock = current["clock"] = StepClock(torch)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, inter = run_chain(torch, pipe, x, clock)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run_stages = {k: list(v) for k, v in stages.items()}  # this run's, not the profiled run's
    valid_counts = {k: valid_count(v) for k, v in valid.items()}
    frame = valid["final"][-1][0]  # the final stage's last detection input

    n = num_mel_chunks(inter["mel"].shape[1], 25.0)
    nf = len(x["frames"])
    ok_shape = out.shape == (n, 1024, 1024, 3) and out.dtype == np.uint8
    std = float(out.astype(np.float32).std())
    stab = inter["stab"].cpu().numpy()
    enhanced = inter["enhanced"].cpu().numpy()
    ok_steps = (inter["boxes"].shape == (nf, 4) and inter["semantic"].shape == (nf, 262)
                and bool(np.isfinite(inter["semantic"]).all())
                and stab.shape == (nf, 256, 256, 3) and stab.std() > 0)
    step5_changed = float(np.abs(enhanced.astype(np.int32) - stab).mean())
    ok_step5 = (enhanced.shape == stab.shape and enhanced.dtype == np.uint8
                and step5_changed > 0 and valid_counts["step5"] == (nf, nf))
    ok_final = valid_counts["final"] == (n, n)
    coverage, change = mouth_checks(torch, mouth.parsenet, last["restored"].to(torch.uint8),
                                    last["frames"], last["out"], last["boxes"].cpu().numpy(), 512)
    ok_mouth = valid_counts["mouth"] == (n, n) and coverage > 0.99 and change > 5.0
    print(f"slice: Steps 1-3: boxes {inter['boxes'].shape}, FFHQ crop {inter['coords']}, "
          f"coefficients {inter['semantic'].shape}, stabilised {stab.shape} std "
          f"{stab.std():.2f}; Step 5: {enhanced.shape}, valid faces {valid_counts['step5'][0]} "
          f"of {valid_counts['step5'][1]}, mean change {step5_changed:.2f} gray levels; mouth "
          f"tail valid faces {valid_counts['mouth'][0]} of {valid_counts['mouth'][1]}, mouth "
          f"mask {100 * coverage:.1f}% of the boxes (last batch), mean change in the boxes "
          f"{change:.2f} gray levels; final "
          f"stage valid faces {valid_counts['final'][0]} of {valid_counts['final'][1]}; output "
          f"{out.shape} {out.dtype}, std {std:.2f}, mel {tuple(inter['mel'].shape)}, {n} "
          f"chunks; {'ok' if ok_shape and std > 0 and ok_steps and ok_step5 and ok_final and ok_mouth else 'FAIL'}")
    if not ok_shape:
        fail(f"slice output {out.shape} {out.dtype}, want ({n}, 1024, 1024, 3) uint8")
    if not std > 0:
        fail("slice output is constant")
    if not ok_steps:
        fail("slice: a Step 1-3 output is malformed, constant or not finite")
    if not ok_step5:
        fail(f"slice: Step 5 found faces in {valid_counts['step5']} frames or left them as "
             "they were")
    if not ok_final:
        fail(f"slice: the final stage found faces in {valid_counts['final']} frames")
    if not ok_mouth:
        fail(f"slice: the mouth tail found faces in {valid_counts['mouth']} frames, its mask "
             f"covered {coverage:.3f} of the boxes, it moved them by {change:.2f} gray levels")
    want = {"fused_act": 38 * n, "fused_act_bwd": 0, "upfirdn2d": 27 * n}
    for name, count in launches.items():
        print(f"slice: {name} launches {count} on the main path "
              f"({count / n:.1f} per frame; expected {want[name] // n})")
        if count == 0 and want[name]:
            fail(f"{name} never launched on the main path")
        elif count != want[name]:
            fail(f"{name} launched {count} times, expected {want[name]}")

    # a third run, each step profiled (Step 5 by its parts)
    prof = current["clock"] = StepClock(torch, profile=set(PROFILED) | {"synthesize"})
    torch.cuda.synchronize()
    run_chain(torch, pipe, x, prof)
    # a fourth run with the tail's parts each under its own profiler session
    clock_methods(mouth.restorer, lambda: current["clock"], dict(
        _detect="mouth_detect", _restore_paste="mouth_restore_paste"))
    clock_methods(mouth, lambda: current["clock"], dict(_blend="mouth_parse_blend"))
    tail_prof = current["clock"] = StepClock(torch, profile=set(TAIL))
    torch.cuda.synchronize()
    run_chain(torch, pipe, x, tail_prof)
    tail_dev = {k: tail_prof.device_ms[k] / n for k in TAIL}
    tail_wall = sum(run_stages["mouth"]) / n
    print(f"slice: mouth tail per output frame ({n} frames, one call): wall {tail_wall:.2f} ms "
          f"(synchronised at its ends), device {sum(tail_dev.values()):.2f} ms: detection "
          f"(RetinaFace-R50 512^2, f32) {tail_dev['mouth_detect']:.2f}, restore + paste "
          f"(GFPGANv1Clean 512, bf16) {tail_dev['mouth_restore_paste']:.2f}, parse + blend "
          f"(ParseNet 512^2 f32, 10-level blend) {tail_dev['mouth_parse_blend']:.2f}; {card}")
    tail_top = {}
    for name in TAIL:
        for key, calls, ms in tail_prof.rows[name]:
            c, m = tail_top.get(key, (0, 0.0))
            tail_top[key] = (c + calls, m + ms)
    tail_top = sorted(tail_top.items(), key=lambda kv: -kv[1][1])[:8]
    for key, (calls, ms) in tail_top:
        print(f"  {ms:8.2f} ms {calls:5d}x  {key[:90]}")
    steps_wall = sum(clock.ms[k] for k in STEPS)
    steps_dev = sum(prof.device_ms[k] for k in PROFILED if k not in STEP5)
    print(f"slice: Steps 1-3 and 5 per frame ({nf} frames), wall / device ms; {card}")
    # extract_coeffs' device work is ReconNet's; the alignment runs on the host
    step_dev = dict(prof.device_ms, host_alignment=0.0, recon=prof.device_ms["coeffs"])
    step_dev["step5"] = sum(prof.device_ms[k] for k in STEP5)
    for k in STEPS + ("step5",) + STEP5:
        print(f"  {k:16s} {clock.ms[k] / nf:8.2f} / {step_dev[k] / nf:.2f}")
    print(f"  Steps 1-3 {steps_wall:.1f} ms wall, {steps_dev:.1f} ms device, busy "
          f"{100 * steps_dev / steps_wall:.1f}% of the unprofiled wall; Step 5 "
          f"{clock.ms['step5']:.1f} ms wall, {step_dev['step5']:.1f} ms device")
    merged = {}
    for name in PROFILED:
        for key, calls, ms in prof.rows[name]:
            c, m = merged.get(key, (0, 0.0))
            merged[key] = (c + calls, m + ms)
    top = sorted(merged.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"profile: Steps 1-3 and 5 ({nf} frames at {x['frames'].shape[1]}x"
          f"{x['frames'].shape[2]}), top kernels by device ms; {card}")
    for key, (calls, ms) in top:
        print(f"  {ms:8.2f} ms {calls:5d}x  {key[:90]}")
    # the final stage's RetinaFace pass on its last input (a 1024^2 frame),
    # alone: device ms from CUDA events, wall ms synchronised
    final_detect_dev = event_ms(torch, lambda: detect(frame)) / len(frame)
    final_detect_wall = wall_ms(torch, lambda: detect(frame)) / len(frame)
    per = dict(step_wall_ms=dict(clock.ms), step_device_ms=step_dev,
               steps_wall_ms=steps_wall, steps_device_ms=steps_dev,
               steps_busy_share=steps_dev / steps_wall,
               steps_top=[dict(name=k[:90], calls=c, ms=m) for k, (c, m) in top],
               step5_wall_per_frame_ms=clock.ms["step5"] / nf,
               step5_device_per_frame_ms=step_dev["step5"] / nf,
               final_detect_wall_per_frame_ms=final_detect_wall,
               final_detect_device_per_frame_ms=final_detect_dev,
               final_detect_shape=list(frame.shape), valid=valid_counts,
               enet_batch_ms=run_stages["enet_batch"],
               mouth_wall_per_frame_ms=tail_wall, mouth_device_per_frame_ms=tail_dev,
               mouth_top=[dict(name=k[:90], calls=c, ms=m) for k, (c, m) in tail_top],
               mouth_mask_coverage=coverage, mouth_box_change=change,
               final_per_frame_ms=sum(run_stages["final"]) / n, total_ms=total_ms,
               synthesize_ms=clock.ms["synthesize"], mel_ms=clock.ms["mel"],
               frames_per_s=n / total_ms * 1e3, peak_gib=peak)
    print(f"slice: final stage RetinaFace on {tuple(frame.shape)} frames: "
          f"{per['final_detect_wall_per_frame_ms']:.2f} ms/frame wall, "
          f"{final_detect_dev:.2f} ms/frame device; {card}")
    print(f"slice: mel {per['mel_ms']:.1f} ms; ENet per batch "
          f"{', '.join(f'{v:.1f}' for v in run_stages['enet_batch'])} ms; final stage "
          f"{per['final_per_frame_ms']:.1f} ms/frame; synthesize {per['synthesize_ms']:.1f} "
          f"ms; mouth tail {tail_wall:.1f} ms/frame; chain total {total_ms:.1f} ms ({per['frames_per_s']:.2f} frames/s); peak "
          f"{peak:.1f} GiB; {card}")
    per["profile"] = profile_rows(prof.rows["synthesize"], "synthesize in the profiled run",
                                  per["synthesize_ms"])
    return launches, per


# the LipSyncPipeline methods the CLI phase times per run (landmark sweeps:
# Step 1's, the FFHQ crops' and, inside synthesize, the reference faces')
CLI_STEPS = dict(extract_landmarks="landmark_sweeps", ffhq_crop="ffhq_crop",
                 extract_coeffs="coeffs", stabilize="dnet", enhance_reference="step5",
                 synthesize="synthesize")


def write_wav(path, wav):
    import wave

    pcm = (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def phase_cli(torch, card):
    """The ``infer`` command at full width from checkpoint files: the slice's
    seeded modules saved as reference-format files in a temporary directory
    (with GPEN-BFR-512, which enables Step 5, the BFM landmarks and a zero
    expression), the slice's clip as .npz and .wav, then
    ``s2v_torch.cli.main(["infer", ...])`` three times with one --tmp_dir:
    cold, warm (the artifact cache hit: Steps 1-3 and 5 not called) and
    with --re_preprocess. Landmark-driven geometry comes from the random
    FAN here (the CLI has no injection). Then the ``train`` command on the
    same files and clip (``run_train_cmd``), the opt-in ``infer`` settings
    (``run_options``) and ``--parallel.infer_mesh`` (``run_infer_mesh``).
    Returns the CLI's launches and report, and the train command's, the
    options' and the mesh's (launches, report)."""
    import shutil
    import tempfile

    from s2v_torch import cli
    from s2v_torch.models.gpen import FullGenerator

    t = time.perf_counter()
    models = full_models(torch)
    steps = steps_models(torch, slim=False, face_bias=20.0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gpen512 = FullGenerator(size=512)
    work = Path(tempfile.mkdtemp(prefix="s2v_cli_"))
    try:
        ckpt = cli.write_checkpoint_dir(
            str(work / "checkpoints"),
            dict(steps, enet=models["enet"], retinaface=models["retinaface"],
                 parsenet=models["parsenet"], gfpgan=models["gfpgan"], gpen512=gpen512,
                 gpen2048=models["facegan"], srmodel=models["srmodel"]),
            lm3d=LM3D, expression=np.zeros(64, np.float32))
        size_gb = sum(f.stat().st_size for f in Path(ckpt).rglob("*") if f.is_file()) / 1e9
        del models, steps, gpen512
        x = clip_inputs(8, 512, 512, 0.4, seed=0)
        np.savez(work / "clip.npz", frames=x["frames"], fps=25.0)
        write_wav(work / "speech.wav", x["wav"])
        print(f"cli: wrote {size_gb:.2f} GB of checkpoints and the clip in "
              f"{time.perf_counter() - t:.1f} s")
        launches, report = run_cli(torch, card, work, ckpt)
        torch.cuda.empty_cache()
        mesh = run_infer_mesh(torch, card, work, ckpt, np.load(report["runs"][0]["out"])["frames"])
        torch.cuda.empty_cache()
        train_cmd = run_train_cmd(torch, card, work, ckpt)
        torch.cuda.empty_cache()
        return (launches, report, train_cmd, run_options(torch, card, work, ckpt, x["frames"]),
                mesh)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_cli(torch, card, work, ckpt):
    """The CLI phase's runs and checks (``phase_cli``)."""
    from s2v_torch import cli
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.pipeline.inference import LipSyncPipeline as pipeline_cls

    real_load = cli.load_models
    loads, last, valid = [], {}, {"step5": [], "mouth": [], "final": []}

    def record(m):
        record_valid(m.ref_enhancer.enhancer, valid["step5"])
        record_valid(m.mouth_restorer.restorer, valid["mouth"])
        record_valid(m.final_enhancer.enhancer, valid["final"])

    def load_models(*a, **k):
        """load_models timed; the run's enhancers record their valid faces."""
        last.clear()  # the previous run's models go before these load
        t0 = time.perf_counter()
        m = last["models"] = real_load(*a, **k)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        record(m)
        return m

    calls = {}
    clock = {}
    originals = {attr: getattr(pipeline_cls, attr) for attr in CLI_STEPS}
    for attr, name in CLI_STEPS.items():
        def counted(*a, _fn=originals[attr], _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        setattr(pipeline_cls, attr, counted)
    clock_methods(pipeline_cls, lambda: clock["now"], CLI_STEPS)
    cli.load_models = load_models
    argv = ["infer", "--face", str(work / "clip.npz"), "--audio", str(work / "speech.wav"),
            "--checkpoint_dir", ckpt, "--tmp_dir", str(work / "tmp")]
    runs = []

    def timed(label, fn, profile=None):
        calls.clear()
        for v in valid.values():
            v.clear()
        clock["now"] = StepClock(torch, profile)
        torch.cuda.reset_peak_memory_stats()
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, load_s = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(label=label, out=out, frames=np.load(out)["frames"], main_s=wall,
                         load_s=load_s, run_s=wall - load_s, launches=launch_counts(),
                         calls=dict(calls), step_ms=dict(clock["now"].ms),
                         valid={k: valid_count(v) for k, v in valid.items()},
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         new_segments=torch.cuda.memory_stats().get("segment.all.allocated", 0)
                         - segments, device_ms=dict(clock["now"].device_ms),
                         top={k: [dict(name=n[:90], calls=c, ms=m) for n, c, m in rows[:8]]
                              for k, rows in clock["now"].rows.items()}))

    try:
        for label, extra in (("cold", []), ("warm", []), ("re_preprocess", ["--re_preprocess"])):
            timed(label, lambda: (cli.main(argv + ["--outfile", str(work / f"{label}.npz"),
                                                   *extra]), loads[-1]))
        # the warm run twice more on the models the last main() loaded: what
        # a run costs once the process has run one
        pipe = pipeline_cls(cli.parse_args(argv[1:]), last.pop("models"))
        for i, profile in ((1, None), (2, None), (3, {"landmark_sweeps"})):
            timed(f"warm, models loaded ({i})",
                  lambda: (pipe.run(str(work / "clip.npz"), str(work / "speech.wav"),
                                    str(work / f"loaded{i}.npz")), 0.0), profile)
        del pipe
    finally:
        cli.load_models = real_load
        for attr, fn in originals.items():
            setattr(pipeline_cls, attr, fn)

    first = runs[0]["frames"]
    n = len(first)
    want = {"fused_act": 38 * n, "fused_act_bwd": 0, "upfirdn2d": 27 * n}
    ok_shape = first.shape == (7, 1024, 1024, 3) and first.dtype == np.uint8
    print(f"cli: output {first.shape} {first.dtype}, std {first.std():.2f}; "
          f"{'ok' if ok_shape and first.std() > 0 else 'FAIL'}")
    if not ok_shape:
        fail(f"cli output {first.shape} {first.dtype}, want (7, 1024, 1024, 3) uint8")
    if not first.std() > 0:
        fail("cli output is constant")
    recomputed = {"landmark_sweeps": 3, "ffhq_crop": 1, "coeffs": 1, "dnet": 1, "step5": 1,
                  "synthesize": 1}
    cached = {"landmark_sweeps": 1, "synthesize": 1}
    expect_calls = {"cold": recomputed, "re_preprocess": recomputed, "warm": cached,
                    **{f"warm, models loaded ({i})": cached for i in (1, 2, 3)}}
    for r in runs:
        d = np.abs(r["frames"].astype(np.int32) - first.astype(np.int32))
        r["subpixels_off_by_more_than_1"] = int((d > 1).sum())
        r["subpixels_differing"] = int((d > 0).sum())
        r["frames_per_s"] = n / r["run_s"]
        steps = ", ".join(f"{k} {v:.1f}" for k, v in r["step_ms"].items())
        print(f"cli: {r['label']} run: main {r['main_s']:.2f} s = load_models "
              f"{r['load_s']:.2f} s + run {r['run_s']:.2f} s ({r['frames_per_s']:.2f} frames/s); "
              f"per step ms (synchronised at each step's ends) {steps}; peak "
              f"{r['peak_gib']:.1f} GiB, {r['new_segments']} new allocator segments; valid "
              f"faces {r['valid']}; launches {r['launches']}; "
              f"{r['subpixels_differing']} subpixels differ from the cold run's "
              f"({r['subpixels_off_by_more_than_1']} by more than 1); {card}")
        for step, rows in r["top"].items():
            print(f"  {step} under torch.profiler: device {r['device_ms'][step]:.1f} ms, top "
                  "kernels:")
            for row in rows:
                print(f"  {row['ms']:8.2f} ms {row['calls']:5d}x  {row['name']}")
        if r["calls"] != expect_calls[r["label"]]:
            fail(f"cli {r['label']} run called {r['calls']}, expected "
                 f"{expect_calls[r['label']]}")
        if r["launches"] != want:
            fail(f"cli {r['label']} run launched {r['launches']}, expected {want}")
        if r["frames"].shape != first.shape or (d > 1).mean() > 1e-3:
            fail(f"cli {r['label']} run's output is off the cold run's: "
                 f"{r['subpixels_off_by_more_than_1']} subpixels by more than 1")
        counts = r["valid"]
        if r["calls"].get("step5") and counts["step5"] != (8, 8):
            fail(f"cli {r['label']} run: Step 5 found faces in {counts['step5']} frames")
        if counts["mouth"] != (n, n) or counts["final"] != (n, n):
            fail(f"cli {r['label']} run: the mouth tail / final stage found faces in "
                 f"{counts['mouth']} / {counts['final']} frames")
    for r in runs:
        del r["frames"]
    return runs[0]["launches"], dict(runs=runs)


def run_infer_mesh(torch, card, work, ckpt, want):
    """``infer --parallel.infer_mesh true`` on the CLI phase's files and clip:
    through ``cli.main`` on the one-card mesh, then through ``load_models(...,
    mesh=make_mesh(devices=["cuda:0", "cuda:0"]))`` with two replicas on the
    card, so that the split and the gather run on the device. Each run's
    frames within one gray level of the plain run's ``want`` (0.1% of
    subpixels at most), every face valid, K1/K3 launches as derived."""
    from s2v_torch import cli
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.parallel.mesh import make_mesh
    from s2v_torch.pipeline.inference import LipSyncPipeline
    from s2v_torch.train.gan import kernel_sites

    argv = ["--face", str(work / "clip.npz"), "--audio", str(work / "speech.wav"),
            "--checkpoint_dir", ckpt, "--parallel.infer_mesh", "true"]
    real_load = cli.load_models
    valid, built, sites = {"step5": [], "mouth": [], "final": []}, [], {}

    def load_models(*a, **k):
        m = real_load(*a, **k)
        record_valid(m.ref_enhancer.enhancer, valid["step5"])
        record_valid(m.mouth_restorer.restorer, valid["mouth"])
        record_valid(m.final_enhancer.enhancer, valid["final"])
        sites["gpen"] = kernel_sites(m.final_enhancer.enhancer.models["facegan"])
        built.append(m)
        return m

    def two_replicas(tag):
        cfg = cli.parse_args(argv + ["--tmp_dir", str(work / f"tmp_{tag}")])
        mesh = make_mesh(devices=["cuda:0", "cuda:0"])
        pipe = LipSyncPipeline(cfg, load_models(ckpt, cfg, mesh=mesh), mesh=mesh)
        return pipe.run(str(work / "clip.npz"), str(work / "speech.wav"),
                        str(work / f"{tag}.npz"))

    runs = []
    try:
        cli.load_models = load_models
        for label, fn in (
                ("one-card mesh (cli.main)", lambda: cli.main(
                    ["infer", *argv, "--tmp_dir", str(work / "tmp_mesh1"),
                     "--outfile", str(work / "mesh1.npz")])),
                ("two replicas on the card", lambda: two_replicas("mesh2"))):
            for v in valid.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mesh = built[-1].final_enhancer.enhancer.mesh
            runs.append(dict(label=label, wall_s=wall, launches=launch_counts(),
                             frames=np.load(out)["frames"], mesh=repr(mesh),
                             valid={k: valid_count(v) for k, v in valid.items()},
                             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                             data=mesh.shape["data"]))
    finally:
        cli.load_models = real_load
    built.clear()

    n = len(want)
    # GPEN-BFR-2048 runs one frame a device per forward: a chunk of one frame
    # per data device, split when its frames divide the data axis
    g1, g3 = sites["gpen"]
    report = []
    for r in runs:
        d = r["data"]
        chunks = [min(d, n - i) for i in range(0, n, d)]
        calls = sum(c if c % d == 0 else 1 for c in chunks)
        expect = {"fused_act": g1 * calls, "fused_act_bwd": 0, "upfirdn2d": g3 * calls}
        diff = np.abs(r.pop("frames").astype(np.int32) - want.astype(np.int32))
        r.update(expect=expect, gpen_calls=calls, subpixels_differing=int((diff > 0).sum()),
                 share_over_1=float((diff > 1).mean()), frames_per_s=n / r["wall_s"])
        ok = (r["launches"] == expect and r["share_over_1"] <= 1e-3
              and r["valid"]["mouth"] == (n, n) and r["valid"]["final"] == (n, n)
              and r["valid"]["step5"] == (8, 8))
        print(f"infer mesh: {r['label']} {r['mesh']}: {r['wall_s']:.2f} s with load_models "
              f"({r['frames_per_s']:.2f} frames/s), peak {r['peak_gib']:.1f} GiB; launches "
              f"{r['launches']}, derived {expect} ({calls} GPEN-2048 forwards of {g1} K1 and "
              f"{g3} K3 sites); {r['subpixels_differing']} subpixels differ from the plain "
              f"run's ({r['share_over_1']:.2e} by more than 1, tol 1e-3); valid faces "
              f"{r['valid']}; {'ok' if ok else 'FAIL'}; {card}")
        if not ok:
            fail(f"infer mesh {r['label']}: launches {r['launches']} (want {expect}), "
                 f"{r['share_over_1']:.2e} of subpixels off by more than 1, valid {r['valid']}")
        report.append(r)
    return runs[0]["launches"], report


def init_nccl(torch, work):
    """A one-rank NCCL group met through a FileStore in ``work``."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(str(work / "nccl_store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))


GAN_DP_PAIRS = 2


def gan_dp_run(torch, mesh, shard=(0, 1), seed=0):
    """GPEN-BFR-512 step pairs 0-1 (R1 at 0) from ``gan_models`` seed 0 on
    the training phase's first batch (its rank's shard under a mesh); the
    state, each step's launches, and the flattened gradients (averaged over
    the group) that pair 0's steps took: D's at the R1 step, then G's."""
    from s2v_torch.ops.kernels import launch_counts
    from s2v_torch.train.gan import make_gan_trainer

    g, d = gan_models(torch, 512, seed, channel_multiplier=2, narrow=1.0, style_dim=512, n_mlp=8)
    batch, _ = train_batches(512, 8, 4, 1, seed=0)
    rank, world = shard
    batch = {k: torch.as_tensor(np.array_split(v, world)[rank]).cuda()
             for k, v in batch[0].items()}
    state, d_step, g_step = make_gan_trainer(g, d, d_reg_every=16, mesh=mesh)
    steps, grads = [], []
    for pair in range(GAN_DP_PAIRS):
        for kind, fn, net in (("d_r1" if state.step % 16 == 0 else "d", d_step, "d"),
                              ("g", g_step, "g")):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            torch.cuda.synchronize()
            after = launch_counts()
            steps.append(dict(kind=kind, ms=(time.perf_counter() - t0) * 1e3,
                              metrics={k: float(v) for k, v in m.items()},
                              launches={k: after[k] - before[k] for k in after}))
            if pair == 0:
                grads.append(torch.cat([p.grad.reshape(-1) for p in getattr(state, net)
                                        .parameters() if p.grad is not None]).cpu())
    return state, steps, grads


def rel_l2(got, want):
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    num = sum(float((g.float() - w.float()).square().sum()) for g, w in zip(got, want))
    return math.sqrt(num / sum(float(w.float().square().sum()) for w in want))


def update_err(after, before, want):
    """Relative L2 of the updates: parameters ``after`` against ``want``,
    both moved from ``before`` (lists of tensors)."""
    return rel_l2([a.float() - b.float() for a, b in zip(after, before)],
                  [w.float() - b.float() for w, b in zip(want, before)])


def gan_dp_gloo_rank(rank, world, work, out_path):
    """A rank of the two-rank gloo group on the card: its half of the batch;
    rank 0 saves the trained parameters. Then the same run with D's
    minibatch-stddev channel taken over each rank's own half (a planted
    fault: the check must see it), whose parameters rank 0 saves too."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from s2v_torch.models import gpen
    from s2v_torch.parallel.mesh import data_group, make_process_mesh, replicas_agree

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(work) / "gloo_store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_process_mesh(world, 1)
        state, steps, grads = gan_dp_run(torch, mesh, (rank, world))
        agree = replicas_agree(list(state.g.parameters()) + list(state.d.parameters())
                               + list(state.g_ema.parameters()), data_group(mesh))
        out = dict(g=[p.detach().cpu() for p in state.g.parameters()],
                   d=[p.detach().cpu() for p in state.d.parameters()], grads=grads, steps=steps,
                   agree=agree)
        del state
        whole_batch = gpen.minibatch_stddev
        gpen.minibatch_stddev = lambda x, group=None: whole_batch(x, None)
        try:
            planted, _, planted_grads = gan_dp_run(torch, mesh, (rank, world))
        finally:
            gpen.minibatch_stddev = whole_batch
        out["planted"] = {m: [p.detach().cpu() for p in getattr(planted, m).parameters()]
                          for m in ("g", "d")}
        out["planted"]["grads"] = planted_grads
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def gloo_cuda_refusal(torch, work):
    """The collective gloo refuses on CUDA tensors in a two-rank group, or
    None when it takes every one the trainers use (all-reduce sum, max and
    min; all-gather; broadcast)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gloo_probe_rank, args=(r, 2, str(work), q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        refused = [q.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    return next((r for r in refused if r), None)


def _gloo_probe_rank(rank, world, work, q):
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(Path(work) / "probe_store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device="cuda")
    refused = None
    for name, fn in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                     ("all_reduce MAX", lambda: dist.all_reduce(x.clone(), dist.ReduceOp.MAX)),
                     ("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(x) for _ in range(world)], x)),
                     ("broadcast", lambda: dist.broadcast(x.clone(), 0))):
        try:
            fn()
        except Exception as e:  # the refusal is reported, not swallowed
            refused = f"{name}: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
            break
    dist.destroy_process_group()
    q.put(refused)


# relative L2 bounds of the data-parallel GPEN checks: pair 0's gradients
# (R1's D step, then G's) and the parameters after both pairs. Sound runs
# measured up to 1.1e-4 and 1.6e-5 (cuDNN's backward is not deterministic,
# and G's step reads D after one Adam step), a rank-local minibatch stddev
# 1.25e-2 and 5.0e-4 (D)
GAN_DP_TOL = dict(grads=1e-3, params=1e-4)


def gan_dp_errs(got, want):
    """Relative L2 of pair 0's gradients (per step) and of the parameters
    (G, D) of ``got`` against ``want`` (dicts with "grads", "g", "d")."""
    return dict(grads=[rel_l2([a], [b]) for a, b in zip(got["grads"], want["grads"])],
                params=[rel_l2(got[m], want[m]) for m in ("g", "d")])


def gan_dp_within(errs):
    return all(max(errs[k]) <= tol for k, tol in GAN_DP_TOL.items())


def gan_dp_text(errs):
    return (f"pair 0 gradients D (R1) {errs['grads'][0]:.2e}, G {errs['grads'][1]:.2e}; "
            f"parameters G {errs['params'][0]:.2e}, D {errs['params'][1]:.2e} relative L2 "
            f"(tol {GAN_DP_TOL})")


def phase_gan_dp(torch, card, work):
    """Data-parallel GPEN training on the card: ``make_gan_trainer(...,
    mesh=make_process_mesh())`` on the one-rank NCCL group against the
    trainer without a mesh from the same state and batch (pair 0's
    gradients and the parameters after both pairs within ``GAN_DP_TOL``,
    launches per step held to ``expected_train_launches``); then, when
    gloo takes the trainer's collectives on CUDA tensors, two ranks sharing
    the card over gloo (NCCL refuses two ranks on one device) split that
    batch and must equal the one-rank run within ``GAN_DP_TOL``, while the
    same two ranks with a rank-local minibatch stddev must land outside
    it."""
    import torch.multiprocessing as mp

    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.parallel.mesh import make_process_mesh
    from s2v_torch.train.gan import expected_train_launches

    def params_of(state, grads):
        return dict(grads=grads, **{m: [p.detach().cpu() for p in getattr(state, m).parameters()]
                                    for m in ("g", "d")})

    mesh = make_process_mesh(1, 1)
    reset_launch_counts()
    t0 = time.perf_counter()
    state, steps, grads = gan_dp_run(torch, mesh)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = expected_train_launches(state.g, state.d)
    one = params_of(state, grads)
    del state
    plain, plain_steps, plain_grads = gan_dp_run(torch, None)
    errs = gan_dp_errs(one, params_of(plain, plain_grads))
    del plain
    ok = gan_dp_within(errs) and all(st["launches"] == want[st["kind"]] for st in steps)
    print(f"gan dp: one NCCL rank vs no mesh after {GAN_DP_PAIRS} step pairs: "
          f"{gan_dp_text(errs)}; step ms {[round(s['ms'], 1) for s in steps]} (no mesh "
          f"{[round(s['ms'], 1) for s in plain_steps]}); launches per step "
          f"{[s['launches'] for s in steps]}, expected {want}; {wall:.1f} s; "
          f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        fail(f"gan dp: one-rank mesh off the plain trainer ({errs}) or launches off")
    report = dict(one_rank=dict(rel_l2=errs, steps=steps, plain_steps=plain_steps,
                                wall_s=wall, expected=want, tol=GAN_DP_TOL))

    refused = gloo_cuda_refusal(torch, work)
    if refused is not None:
        print(f"gan dp: gloo refused a collective on CUDA tensors: {refused}")
        print("gan dp: the two-rank check stays in the CPU tests "
              "(tests/test_torch_dist_train.py)")
        report["two_ranks_gloo"] = dict(refused=refused)
        return launches, report
    out_path = work / "gan_dp_rank0.pt"
    t0 = time.perf_counter()
    mp.start_processes(gan_dp_gloo_rank, args=(2, str(work), str(out_path)), nprocs=2,
                       join=True, start_method="spawn")
    wall2 = time.perf_counter() - t0
    two = torch.load(out_path)
    errs2 = gan_dp_errs(two, one)
    planted = gan_dp_errs(two["planted"], one)
    ok = gan_dp_within(errs2) and two["agree"] and all(
        st["launches"] == want[st["kind"]] for st in two["steps"])
    seen = not gan_dp_within(planted)
    print(f"gan dp: two gloo ranks on the card (batch 2 each) vs one NCCL rank (batch 4): "
          f"{gan_dp_text(errs2)}; replicas bit-equal {two['agree']}; rank 0 step ms "
          f"{[round(s['ms'], 1) for s in two['steps']]}; launches per step "
          f"{[s['launches'] for s in two['steps']]}; {wall2:.1f} s with both processes' start "
          f"and the planted run; {'ok' if ok else 'FAIL'}; {card}")
    print(f"gan dp: planted rank-local minibatch stddev, two gloo ranks vs one NCCL rank: "
          f"{gan_dp_text(planted)}; {'seen' if seen else 'NOT SEEN'}")
    if not ok:
        fail(f"gan dp: two gloo ranks off the one-rank run ({errs2}), replicas agree "
             f"{two['agree']}, or launches off")
    if not seen:
        fail(f"gan dp: the check does not see a rank-local minibatch stddev ({planted})")
    report["two_ranks_gloo"] = dict(rel_l2=errs2, planted_rel_l2=planted, agree=two["agree"],
                                    steps=two["steps"], wall_s=wall2)
    return launches, report


ARC_CLASSES = 85742  # arcface_torch configs/ms1mv2_r50.py num_classes
ARC_STEPS = 5
# the slim card-vs-CPU check, in the setting of tests/test_torch_arcface.py's
# well-conditioned optimizer test, whose planted optimizer faults land at
# 2.7e-2 (backbone update) and 4.9e-4 (classifier update); the backbone's
# bound is wider than the test's 2e-3 (cuDNN against the CPU's convs: its
# early layers' f32 gradients measured 1.35e-3 at step 2)
ARC_SLIM_LR, ARC_SLIM_WD = 1e-3, 0.5
ARC_SLIM_TOL = dict(backbone_update=5e-3, clf_update=1e-4, state=1e-4)


def phase_arcface(torch, card):
    """``make_arcface_trainer`` at full width on the one-rank NCCL mesh:
    IResNet-50, 512-d, 112^2, batch 128, 85,742 classes (arcface_torch's
    configs/ms1mv2_r50.py), a new batch of random images and labels from a
    seed each step, f32; 5 steps at sample_rate 1.0 and 5 from a fresh state
    at 0.1. Then the slim
    trainer on the card and on the CPU from the same state and batch: each
    step's updates and the state within ``ARC_SLIM_TOL``."""
    from s2v_torch.models.iresnet import IResNet
    from s2v_torch.parallel.mesh import make_process_mesh
    from s2v_torch.parallel.partial_fc import sample_classes, sampling_generator
    from s2v_torch.train.arcface import make_arcface_trainer

    mesh = make_process_mesh(1, 1)
    g = torch.Generator().manual_seed(0)
    batches = [(torch.rand(128, 112, 112, 3, generator=g).cuda(),
                torch.randint(0, ARC_CLASSES, (128,), generator=g).cuda())
               for _ in range(ARC_STEPS)]
    report = {}
    for rate in (1.0, 0.1):
        torch.cuda.reset_peak_memory_stats()
        state, step = make_arcface_trainer(ARC_CLASSES, mesh, 512, (3, 4, 14, 3), seed=0,
                                           sample_rate=rate)
        clf0 = state.clf_weight.detach().clone()
        ms, losses = [], []
        for images, labels in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, images, labels)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        changed = (state.clf_weight.detach() != clf0).any(1).cpu()
        ok = all(math.isfinite(v) for v in losses)
        extra = ""
        if rate < 1.0:
            num = int(rate * ARC_CLASSES)
            picked = torch.zeros(ARC_CLASSES, dtype=torch.bool)
            positives = torch.zeros(ARC_CLASSES, dtype=torch.bool)
            for s, (_, labels) in enumerate(batches):
                lab = labels.cpu()
                idx, _ = sample_classes(lab, torch.ones_like(lab, dtype=torch.bool), ARC_CLASSES,
                                        num, sampling_generator(0, s, 0))
                picked[idx] = True
                positives[lab] = True
            untouched = int((~changed).sum())
            ok = ok and not bool((changed & ~picked).any()) and bool(changed[positives].all()) \
                and untouched >= ARC_CLASSES - ARC_STEPS * num
            extra = (f"; {untouched} of {ARC_CLASSES} classifier rows untouched, every changed "
                     f"row sampled in some step ({int(picked.sum())} sampled), every positive "
                     "row changed")
        steady = sum(ms[1:]) / (len(ms) - 1)
        print(f"arcface r50: sample_rate {rate}: {steady:.1f} ms/step (steps 2-5; step 1 "
              f"{ms[0]:.1f} ms), {128 / steady * 1e3:.0f} images/s, peak {peak:.2f} GiB, "
              f"losses {[round(v, 3) for v in losses]}{extra}; {'ok' if ok else 'FAIL'}; {card}")
        if not ok:
            fail(f"arcface r50 at sample_rate {rate}: losses {losses} or classifier rows off")
        report[f"rate_{rate}"] = dict(ms=ms, ms_per_step=steady, peak_gib=peak, losses=losses,
                                      rows_changed=int(changed.sum()))
        del state, step
        torch.cuda.empty_cache()

    # the slim trainer, card vs CPU, where its gradients are well conditioned
    # (tests/test_torch_arcface.py test_decay_before_momentum_matches_jax)
    rs = np.random.RandomState(3)
    imgs, labs = rs.rand(8, 112, 112, 3).astype(np.float32), rs.randint(0, 16, 8)
    out = {}
    for name, dev, m in (("card", "cuda", mesh), ("cpu", "cpu", None)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            backbone = IResNet((1, 1, 1, 1), 64)
        state, step = make_arcface_trainer(16, m, 64, (1, 1, 1, 1), lr=ARC_SLIM_LR,
                                           weight_decay=ARC_SLIM_WD, seed=1, device=dev,
                                           backbone=backbone)
        runs = [([p.detach().cpu().clone() for p in backbone.parameters()],
                 state.clf_weight.detach().cpu().clone(),
                 [t.detach().cpu().float().clone() for k, t in backbone.state_dict().items()
                  if "num_batches" not in k])]
        for _ in range(2):
            state, metrics = step(state, imgs, labs)
            runs.append(([p.detach().cpu().clone() for p in backbone.parameters()],
                         state.clf_weight.detach().cpu().clone(),
                         [t.detach().cpu().float().clone()
                          for k, t in backbone.state_dict().items() if "num_batches" not in k]))
        out[name] = (runs, float(metrics["loss"]))
    (a, la), (b, lb) = out["card"], out["cpu"]
    errs = []
    for k in (1, 2):
        errs.append(dict(
            backbone_update=update_err(a[k][0], b[k - 1][0], b[k][0]),
            clf_update=update_err([a[k][1]], [b[k - 1][1]], [b[k][1]]),
            state=rel_l2(a[k][2], b[k][2])))
    ok = all(e[key] <= tol for e in errs for key, tol in ARC_SLIM_TOL.items())
    print(f"arcface slim: card (NCCL mesh) vs CPU, lr {ARC_SLIM_LR:g}, weight decay "
          f"{ARC_SLIM_WD:g}, steps 1 and 2, relative L2: "
          + "; ".join(", ".join(f"{key} {e[key]:.2e}" for key in ARC_SLIM_TOL) for e in errs)
          + f" (tol {ARC_SLIM_TOL}), losses {la:.4f} / {lb:.4f}; {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"arcface slim card vs CPU: {errs}")
    report["slim_card_vs_cpu"] = dict(errs=errs, tol=ARC_SLIM_TOL)
    return report


GFPGANER = dict(input_is_latent=True, different_w=True, sft_half=True)  # gfpgan/utils.py:63-74
SLIM_BOX = (10, 80, -6, 130)  # --box top bottom left right, past the slim frames' sides


def options_models(torch):
    """``slim_models`` with the original GFPGANv1 in place of GFPGANv1Clean
    (out_size 64, slim, GFPGANer's wiring; its ToRGB layers scaled by 0.04,
    as the CPU tests scale them, for the reason of
    ``with_unsaturated_rgb``), a slim GANimation SplitGenerator (ngf 16,
    2 blocks) and RetinaFace with live landmarks (``with_live_landmarks``),
    so that bf16 detection changes the output."""
    from s2v_torch.models.ganimation import SplitGenerator
    from s2v_torch.models.gfpgan import GFPGANv1, ToRGBV1

    models = slim_models(torch)
    with_live_landmarks(torch, models["retinaface"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        models["gfpgan"] = GFPGANv1(out_size=64, num_style_feat=64, channel_multiplier=0.5,
                                    narrow=0.5, **GFPGANER)
        models["ganimation"] = SplitGenerator(ngf=16, n_blocks=2)
    with torch.no_grad():
        for m in models["gfpgan"].modules():
            if isinstance(m, ToRGBV1):
                m.modulated_conv.weight *= 0.04
                m.bias *= 0.04
    return models


def options_pipeline(models, cfg, device):
    """The slim Step 6 with every opt-in setting of ``cfg`` wired as
    ``s2v_torch.cli.load_models`` wires it: the mouth tail (RetinaFace,
    GFPGANv1, ParseNet), the final hook (SR) and the GANimation editor.
    Returns (pipeline, tail restorer, final enhancer)."""
    from s2v_torch.pipeline.enhance import FaceEnhancer, final_enhancer_hook
    from s2v_torch.pipeline.inference import LipSyncPipeline, PipelineModels
    from s2v_torch.pipeline.restoration import make_mouth_restorer, make_up_face_editor

    opts = dict(approx_warp=cfg.model.approx_warp, det_dtype=cfg.model.detector_dtype)
    tail = make_mouth_restorer({k: models[k] for k in ("retinaface", "gfpgan", "parsenet")},
                               chunk=4, parse_size=128, dtype=cfg.model.dtype,
                               device=device, **opts)
    final = FaceEnhancer({k: models[k] for k in ("retinaface", "facegan", "parsenet", "srmodel")},
                         in_size=64, dtype=cfg.model.dtype, parse_size=128, device=device,
                         **opts)
    editor = make_up_face_editor({"ganimation": models["ganimation"]}, cfg.infer.up_face,
                                 device=device)
    pipe = LipSyncPipeline(cfg, PipelineModels(enet=models["enet"], mouth_restorer=tail,
                                               final_enhancer=final_enhancer_hook(final),
                                               up_face_editor=editor), device=device)
    return pipe, tail.restorer, final


def phase_options_reference(torch):
    """The slim Step 6 with every opt-in setting at once (GFPGANv1 in the
    tail, --without_rl1 with --up_face surprise, --box past the frame's
    sides, --cropped_image, model.approx_warp) on the card against the CPU,
    f32: within one gray level, every face of the tail and the final stage
    valid on both. Then the same with model.detector_dtype=bfloat16
    (RetinaFace's and the tail ParseNet's convs in bf16). RetinaFace's
    landmarks come from live features here, so bf16 moves them and the CPU's
    bf16 output differs from its f32 one; the card's and the CPU's bf16
    convolutions round independently, so the card's bf16 output is held to
    the CPU's within twice the CPU's own bf16-vs-f32 difference (mean, and
    share of subpixels off by more than 1), or the f32 tolerance where
    larger, and that difference must not be 0."""
    from s2v_torch.utils.config import PipelineConfig, override

    models = options_models(torch)
    x = clip_inputs(6, 96, 112, 0.35, seed=3)
    outs, valid = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg = override(PipelineConfig(), {
            "model.dtype": "float32", "infer.lnet_batch_size": "4", "infer.without_rl1": "true",
            "infer.up_face": "surprise", "infer.box": ",".join(map(str, SLIM_BOX)),
            "infer.cropped_image": "true", "model.approx_warp": "true",
            "model.detector_dtype": dt})
        for dev in ("cpu", "cuda"):
            pipe, restorer, final = options_pipeline(copy.deepcopy(models), cfg, dev)
            sinks = ([], [])
            record_valid(restorer, sinks[0])
            record_valid(final, sinks[1])
            outs[dev, dt] = run_slice(torch, pipe, x, dev)
            valid[dev, dt] = [valid_count(sink) for sink in sinks]
    res = {"valid": {f"{d} {t}": v for (d, t), v in valid.items()}}
    print(f"options reference: valid faces (tail, final) {res['valid']}")
    if any(v != [(6, 6), (6, 6)] for v in valid.values()):
        fail("options reference: not every face valid in the tail and the final stage")
    res["float32"] = frames_agree(
        "options reference: slim Step 6 with GFPGANv1, --without_rl1 --up_face surprise, --box, "
        "--cropped_image, approx_warp, card vs CPU", outs["cuda", "float32"],
        outs["cpu", "float32"], (6, 96, 112, 3))
    d = np.abs(outs["cuda", "bfloat16"].astype(np.int32) - outs["cpu", "bfloat16"])
    gap = np.abs(outs["cpu", "bfloat16"].astype(np.int32) - outs["cpu", "float32"])
    tol_mean = max(2 * float(gap.mean()), 0.01)
    tol_share = max(2 * float((gap > 1).mean()), 1e-3)
    ok = (float(d.mean()) <= tol_mean and float((d > 1).mean()) <= tol_share
          and float(gap.mean()) > 0)
    print(f"options reference: the same with detector_dtype bfloat16, card vs CPU: mean "
          f"{d.mean():.4f} (tol {tol_mean:.4f}), share > 1 gray level {(d > 1).mean():.2e} (tol "
          f"{tol_share:.2e}); the CPU's bf16 vs f32: mean {gap.mean():.4f}, share > 1 "
          f"{(gap > 1).mean():.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("options reference: the bf16 detectors on the card disagree with the CPU's")
    res["bfloat16"] = dict(mean=float(d.mean()), share_over_1=float((d > 1).mean()),
                           cpu_gap_mean=float(gap.mean()),
                           cpu_gap_share_over_1=float((gap > 1).mean()))
    return res


FULL_BOX = (128, 448, 96, 416)  # --box top bottom left right on the 512^2 clip
OPTION_RUNS = (("up_face", ["--up_face", "surprise", "--without_rl1"]),
               ("box_cropped", ["--box", *map(str, FULL_BOX), "--cropped_image"]),
               ("bf16_approx", ["--model.detector_dtype", "bfloat16",
                                "--model.approx_warp", "true"]))


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def run_options(torch, card, work, ckpt, frames):
    """Phase 15: the opt-in ``infer`` settings at full width through
    ``s2v_torch.cli.main``, on the CLI phase's files with GFPGANv1.4.pth
    taken out and a random GFPGANv1.pth (the original arch: GFPGANv1 512,
    channel multiplier 1, narrow 1, GFPGANer's wiring) and 30_net_gen.pth
    (GANimation, ngf 64, 6 blocks) put in, on the CLI phase's clip. Three
    cold runs (a --tmp_dir each): --up_face surprise --without_rl1; --box
    --cropped_image; --model.detector_dtype bfloat16 --model.approx_warp
    true. Each: K1 and K3 launches equal to the chain's 38 and 27 a frame
    plus GFPGANv1's ``forward_launches`` per tail forward; every face valid
    in Step 5, the tail and the final stage; the output's shape (1x under
    --cropped_image, its frames untouched outside the box). For the third,
    the PSNR of its Step 5 (approximate warps) against the second run's
    (exact, f32) on the same frames with landmarks supplied (a face inside
    the frame, where the sheared warp is an approximation): the second
    run's Step-5 input, and smooth frames, where it must exceed
    ``STEP5_PSNR_FLOOR``; and ``approx_warp_checks``."""
    import os

    from s2v_torch import cli
    from s2v_torch.models.ganimation import SplitGenerator
    from s2v_torch.models.gfpgan import GFPGANv1, forward_launches
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.pipeline.inference import LipSyncPipeline as pipeline_cls

    t = time.perf_counter()
    opt_dir = work / "checkpoints_options"
    opt_dir.mkdir()
    for name in os.listdir(ckpt):
        if name != "GFPGANv1.4.pth":
            os.symlink(os.path.join(ckpt, name), opt_dir / name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        v1 = GFPGANv1(out_size=512, **GFPGANER)
        cli.write_checkpoint_dir(str(opt_dir), {"gfpgan_v1": v1, "ganimation": SplitGenerator()})
    per_forward = forward_launches(v1)
    del v1
    print(f"options: wrote GFPGANv1.pth and 30_net_gen.pth in {time.perf_counter() - t:.1f} s; "
          f"GFPGANv1(512) launches per forward {per_forward}")

    real_load, real_enh = cli.load_models, pipeline_cls.enhance_reference
    last, valid = {}, {"step5": [], "mouth": [], "final": []}

    def load_models(*a, **k):
        t0 = time.perf_counter()
        m = last["models"] = real_load(*a, **k)
        torch.cuda.synchronize()
        last["load_s"] = time.perf_counter() - t0
        record_valid(m.ref_enhancer.enhancer, valid["step5"])
        record_valid(m.mouth_restorer.restorer, valid["mouth"])
        record_valid(m.final_enhancer.enhancer, valid["final"])
        return m

    def enhance_reference(self, stab):
        out = real_enh(self, stab)
        last["step5"] = (stab, out[0])  # device tensors: read after the run
        return out

    argv = ["infer", "--face", str(work / "clip.npz"), "--audio", str(work / "speech.wav"),
            "--checkpoint_dir", str(opt_dir)]
    runs, step5 = [], {}
    cli.load_models, pipeline_cls.enhance_reference = load_models, enhance_reference
    try:
        for label, flags in OPTION_RUNS:
            last.clear()
            for v in valid.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cli.main(argv + flags + ["--outfile", str(work / f"opt_{label}.npz"),
                                           "--tmp_dir", str(work / f"tmp_{label}")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            cfg = cli.parse_args(argv[1:] + flags)
            models = last.pop("models")
            step5[label] = tuple(torch.as_tensor(a).cpu().numpy() for a in last["step5"])
            n = len(np.load(out)["frames"])
            batch, chunk = cfg.infer.lnet_batch_size, models.mouth_restorer.restorer.chunk
            forwards = sum(-(-min(batch, n - i) // chunk) for i in range(0, n, batch))
            want = {k: c * forwards for k, c in per_forward.items()}
            want["fused_act"] += 38 * n
            want["upfirdn2d"] += 27 * n
            if label == "box_cropped":  # the exact f32 hooks, run again below
                exact_models = models
            if label == "bf16_approx":  # its Step 5 again, below, on shared inputs
                step5_models = models
            runs.append(dict(label=label, flags=flags, out=np.load(out)["frames"],
                             load_s=last["load_s"], run_s=wall - last["load_s"], main_s=wall,
                             frames_per_s=n / (wall - last["load_s"]),
                             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                             launches=launches, want_launches=want,
                             valid={k: valid_count(v) for k, v in valid.items()}))
            del models
    finally:
        cli.load_models, pipeline_cls.enhance_reference = real_load, real_enh

    # Step 5 of the bf16/approximate run's hooks and of the exact f32 run's
    # on one input, with landmarks supplied (a rolled face inside the frame,
    # where the sheared warp is an approximation; the smoke's RetinaFace
    # puts its crops outside it, ROADMAP.md §3): the clip's Step-5 input and
    # smooth frames, on which the CPU tests hold the warp
    s5_in = torch.as_tensor(step5["box_cropped"][0], device="cuda")
    lms = rolled_face_landmarks(len(s5_in), s5_in.shape[1], 0.6 * s5_in.shape[1])
    smooth = smooth_frames(torch, len(s5_in), s5_in.shape[1], 3, seed=7, device="cuda")
    smooth = smooth.round().to(torch.uint8).permute(0, 2, 3, 1)
    step5_psnr = {}
    for what, stab in (("clip", s5_in), ("smooth", smooth)):
        exact, approx = (torch.as_tensor(m.ref_enhancer(stab, landmarks5=lms)).cpu().numpy()
                         for m in (exact_models, step5_models))
        step5_psnr[what] = psnr(approx, exact)
    del step5_models, exact_models, s5_in, smooth
    warps = approx_warp_checks(torch, card)
    for r in runs:
        o = r.pop("out")
        n = len(o)
        shape = (n, 512, 512, 3) if r["label"] == "box_cropped" else (n, 1024, 1024, 3)
        checks = [o.shape == shape and o.dtype == np.uint8 and o.std() > 0,
                  r["launches"] == r["want_launches"],
                  r["valid"]["mouth"] == (n, n) and r["valid"]["final"] == (n, n)
                  and r["valid"]["step5"] == (8, 8)]
        extra = ""
        if r["label"] == "box_cropped":  # untouched outside the box
            top, bottom = FULL_BOX[:2]
            kept = bool((o[:, :top] == frames[:n, :top]).all()
                        and (o[:, bottom:] == frames[:n, bottom:]).all())
            checks.append(kept)
            r["outside_box_kept"] = kept
            extra = f"; frames untouched outside the box: {kept}"
        if r["label"] == "bf16_approx":
            r["step5_psnr_vs_exact"], r["approx_warps"] = step5_psnr, warps
            checks.append(step5_psnr["smooth"] > STEP5_PSNR_FLOOR)
            extra = (f"; its Step 5 against the exact f32 run's, on the same frames with a "
                     f"face 0.6 of the frame rolled 5 degrees: PSNR {step5_psnr['smooth']:.2f} "
                     f"dB on smooth frames (floor {STEP5_PSNR_FLOOR}), "
                     f"{step5_psnr['clip']:.2f} dB on the clip's Step-5 input")
        r["ok"] = all(checks)
        print(f"options: {r['label']} ({' '.join(r['flags'])}): output {o.shape}; main "
              f"{r['main_s']:.2f} s = load_models {r['load_s']:.2f} s + run {r['run_s']:.2f} s "
              f"({r['frames_per_s']:.2f} frames/s); peak {r['peak_gib']:.1f} GiB; valid faces "
              f"{r['valid']}; launches {r['launches']} (derived {r['want_launches']}){extra}; "
              f"{card} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            fail(f"options {r['label']}: output, launches, valid faces or Step-5 PSNR off")
    return runs[0]["launches"], dict(runs=runs)


# the approximate Step 5 against the exact one on smooth frames: the CPU
# tests' 45 dB for the warp's crop, less the round trip's second warp
STEP5_PSNR_FLOOR = 40.0


def rolled_face_landmarks(n, size, face, roll_deg=5.0):
    """The facexlib template's 5 points for a face ``face`` px wide at the
    centre of a ``size``^2 frame, rolled by ``roll_deg``: [n, 5, 2]."""
    from s2v_torch.pipeline.restoration import FACEXLIB_TEMPLATE_512

    t = math.radians(roll_deg)
    rot = np.asarray([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])
    pts = size / 2.0 + (FACEXLIB_TEMPLATE_512 - 256.0) * (face / 512.0) @ rot.T
    return np.tile(pts[None], (n, 1, 1)).astype(np.float32)


def smooth_frames(torch, n, size, channels, seed, device):
    """[n, channels, size, size] smooth content in 0..255 (uniform noise at
    1/8 the size, resized bilinearly: tests/test_warp_shear.py's)."""
    from s2v_torch.ops.image import resize_bilinear

    g = torch.Generator().manual_seed(seed)
    small = torch.rand(n, channels, size // 8, size // 8, generator=g) * 255.0
    return resize_bilinear(small.to(device), (size, size))


def interior_psnr(torch, exact, approx):
    """PSNR (peak 255) of two warps over their shared footprint eroded by 2
    px (a 5x5 minimum, zeros outside the canvas), as tests/test_warp_shear.py
    measures it: the sheared passes edge-replicate where the exact warp
    blends with zeros."""
    import torch.nn.functional as F

    inner = [1.0 - F.max_pool2d(F.pad(1.0 - (a.abs().sum(1, keepdim=True) > 1e-6).float(),
                                      (2, 2, 2, 2), value=1.0), 5, stride=1)
             for a in (exact, approx)]
    m = ((inner[0] * inner[1]) > 0.5).expand_as(exact)
    mse = ((exact - approx)[m] ** 2).mean().item()
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def approx_warp_checks(torch, card, device="cuda"):
    """model.approx_warp's two warps at the main path's shapes: Step 5's
    crop of 8 256^2 frames to 512^2 and its 5-channel paste back, the mouth
    tail's crop of 7 512^2 frames to 512^2 and its 4-channel paste back,
    each for a face 0.6 of the frame rolled 5 degrees, on smooth content.
    The sheared warp against the exact one over the footprint's interior:
    over 45 dB, as the CPU tests hold it; the card's sheared warp against
    the CPU's on the same inputs: within 2e-3 (values up to 255; the CPU
    tests' tolerance against s2v_tpu's)."""
    from s2v_torch.ops.warp import affine_warp, affine_warp_shear
    from s2v_torch.pipeline.enhance import umeyama_similarity_batched
    from s2v_torch.pipeline.restoration import FACEXLIB_TEMPLATE_512

    template = torch.from_numpy(FACEXLIB_TEMPLATE_512).to(device)
    res = {}
    for what, n, size, paste_ch in (("step5", 8, 256, 5), ("tail", 7, 512, 4)):
        lms = torch.from_numpy(rolled_face_landmarks(n, size, 0.6 * size)).to(device)
        tfms, _ = umeyama_similarity_batched(lms, template)
        x = smooth_frames(torch, n, size, 3, seed=size, device=device)
        crop = [w(x, tfms, (512, 512)) for w in (affine_warp, affine_warp_shear)]
        src = torch.cat([crop[0], torch.ones_like(crop[0][:, :paste_ch - 3])], 1)
        paste = [w(src, tfms, (size, size), inverse=True) for w in (affine_warp, affine_warp_shear)]
        cpu = (affine_warp_shear(x.cpu(), tfms.cpu(), (512, 512)),
               affine_warp_shear(src.cpu(), tfms.cpu(), (size, size), inverse=True))
        r = dict(crop_psnr=interior_psnr(torch, *crop), paste_psnr=interior_psnr(torch, *paste),
                 card_vs_cpu=max((crop[1].cpu() - cpu[0]).abs().max().item(),
                                 (paste[1].cpu() - cpu[1]).abs().max().item()))
        r["ok"] = r["crop_psnr"] > 45.0 and r["paste_psnr"] > 45.0 and r["card_vs_cpu"] <= 2e-3
        print(f"options: approx_warp at {what}'s shapes ({n}x3x{size}^2 -> 512^2, "
              f"{n}x{paste_ch}x512^2 -> {size}^2), sheared vs exact: crop "
              f"{r['crop_psnr']:.2f} dB, paste {r['paste_psnr']:.2f} dB (floor 45); card vs CPU "
              f"{r['card_vs_cpu']:.2e} (tol 2e-3); {card} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            fail(f"options: the sheared warp at {what}'s shapes is off")
        res[what] = r
    return res


def device_rows(prof):
    """(kernel, calls, device ms) of every device row of a torch.profiler
    run, largest first."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = [(e.key, e.count, dev_us(e) / 1e3) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    return sorted(rows, key=lambda r: -r[2])


def profile_rows(rows, what, unprofiled_ms):
    """Device time by kernel (``device_rows``), and the device's busy share
    of the unprofiled run's wall time (the profiler slows the host)."""
    busy_ms = sum(ms for _, _, ms in rows)
    # the port's kernels by their CUDA names (K1 fused_vec/fused_scalar, K2
    # bwd_vec/bwd_scalar, K3 upfirdn2d_strips/upfirdn2d_direct)
    ours = {name: sum(ms for key, _, ms in rows if any(f"::{k}<" in key for k in keys))
            for name, keys in (("fused_act", ("fused_vec", "fused_scalar")),
                               ("fused_act_bwd", ("bwd_vec", "bwd_scalar")),
                               ("upfirdn2d", ("upfirdn2d_strips", "upfirdn2d_direct")))}
    top = [dict(name=key[:90], calls=calls, ms=ms) for key, calls, ms in rows[:15]]
    if busy_ms == 0:
        print(f"profile: {what}: the profiler saw no device time (not measured)")
    else:
        print(f"profile: {what}: device busy {busy_ms:.1f} ms, "
              f"{100 * busy_ms / unprofiled_ms:.1f}% of the unprofiled wall "
              f"{unprofiled_ms:.1f} ms")
        for r in top[:10]:
            print(f"  {r['ms']:8.2f} ms {r['calls']:5d}x  {r['name']}")
        print("  the port's kernels: " + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items()))
    return dict(busy_ms=busy_ms, busy_share=busy_ms / unprofiled_ms, top=top, kernel_ms=ours)


def synthetic_faces(n, size, seed):
    """Smooth face-like uint8 images: a skin-toned ellipse with darker eyes
    and mouth on a gradient background, jittered per image."""
    rng = np.random.RandomState(seed)
    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        cx, cy = 0.5 + rng.uniform(-0.05, 0.05, 2)
        img = np.stack([xx * 120 + 60, yy * 100 + 50, (xx + yy) * 60 + 40], -1)
        face = ((xx - cx) / 0.32) ** 2 + ((yy - cy) / 0.42) ** 2 < 1
        img[face] = rng.uniform(150, 230) * np.array([1.0, 0.8, 0.65])
        for ex in (-0.12, 0.12):
            img[((xx - cx - ex) / 0.06) ** 2 + ((yy - cy + 0.1) / 0.03) ** 2 < 1] = 40
        img[((xx - cx) / 0.14) ** 2 + ((yy - cy - 0.2) / 0.04) ** 2 < 1] = (150, 50, 60)
        out[i] = np.clip(img + rng.randn(size, size, 3) * 4, 0, 255).astype(np.uint8)
    return out


def gan_models(torch, size, seed, **kw):
    from s2v_torch.models.gpen import Discriminator, FullGenerator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = FullGenerator(size=size, **kw)
        d = Discriminator(size=size, channel_multiplier=kw.get("channel_multiplier", 2),
                          narrow=kw.get("narrow", 1.0))
    return g, d


def train_batches(size, n_images, batch, n_batches, seed):
    """``face_batches`` over synthetic faces, JPEG off (the card's machine has
    no Pillow); returns the batches and the host seconds per batch."""
    from s2v_torch.prep.degradations import GFPGANDegrader, face_batches

    faces = synthetic_faces(n_images, size, seed)
    t = time.perf_counter()
    batches = list(face_batches(faces, batch, rng=np.random.default_rng(seed),
                                degrader=GFPGANDegrader(jpeg_range=None), steps=n_batches))
    return batches, (time.perf_counter() - t) / n_batches


def phase_train_reference(torch):
    """One R1 d_step, one g_step and one plain d_step at slim widths on the
    card (kernels) and on the CPU (plain versions), each step started from
    the CPU's parameters of the moment; metrics within rtol 1e-3 and every
    parameter gradient within 5e-3 of that parameter's largest (f32, cuDNN
    and the CPU sum in other orders, through a double backward)."""
    from s2v_torch.train.gan import make_gan_trainer

    kw = dict(narrow=0.25, channel_multiplier=0.5, style_dim=64, n_mlp=2)
    g, d = gan_models(torch, 64, 2, **kw)
    batches, _ = train_batches(64, 4, 4, 1, seed=2)
    runs = {dev: make_gan_trainer(copy.deepcopy(g), copy.deepcopy(d), device=dev)
            for dev in ("cpu", "cuda")}
    worst, worst_metric = 0.0, 0.0
    for kind in ("d_r1", "g", "d"):
        ref = runs["cpu"][0]
        for mod in ("g", "d"):
            getattr(runs["cuda"][0], mod).load_state_dict(getattr(ref, mod).state_dict())
        out = {}
        for dev, (state, d_step, g_step) in runs.items():
            _, m = (g_step if kind == "g" else d_step)(state, batches[0])
            module = state.g if kind == "g" else state.d
            out[dev] = ({k: float(v) for k, v in m.items()},
                        {k: None if p.grad is None else p.grad.detach().cpu()
                         for k, p in module.named_parameters()})
        (m_cpu, g_cpu), (m_dev, g_dev) = out["cpu"], out["cuda"]
        for k in m_cpu:
            rel = abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
            worst_metric = max(worst_metric, rel)
            if rel > 1e-3:
                fail(f"train reference {kind}: metric {k} card {m_dev[k]} vs CPU {m_cpu[k]}")
        for k, want in g_cpu.items():
            got = g_dev[k]
            if (got is None) != (want is None):
                fail(f"train reference {kind}: {k} has a gradient on one device only")
                continue
            if want is None:
                continue
            scale = max(want.abs().max().item(), 1e-30)
            ratio = (got - want).abs().max().item() / scale
            worst = max(worst, ratio)
            if not ratio <= 5e-3:
                fail(f"train reference {kind}: gradient of {k} off by {ratio:.2e} of its scale")
        print(f"train reference {kind}: metrics {m_dev} (CPU {m_cpu})")
    print(f"train reference: slim GPEN-64 card vs CPU, worst metric rel {worst_metric:.2e} "
          f"(tol 1e-3), worst gradient err / scale {worst:.2e} (tol 5e-3) "
          f"{'ok' if worst <= 5e-3 and worst_metric <= 1e-3 else 'FAIL'}")
    return dict(worst_grad_ratio=worst, worst_metric_rel=worst_metric)


def phase_train(torch, card):
    """GPEN-BFR-512 adversarial training steps 0-16 at full width."""
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.train.gan import expected_train_launches, make_gan_trainer

    t = time.perf_counter()
    g, d = gan_models(torch, 512, 0, channel_multiplier=2, narrow=1.0, style_dim=512, n_mlp=8)
    want = expected_train_launches(g, d)
    print(f"train: built GPEN-BFR-512 G ({sum(p.numel() for p in g.parameters()) / 1e6:.1f}M "
          f"params) and D ({sum(p.numel() for p in d.parameters()) / 1e6:.1f}M) in "
          f"{time.perf_counter() - t:.1f} s; launches per step derived from the models: {want}")
    batches, host_s = train_batches(512, 8, 4, 2, seed=0)
    print(f"train: face_batches host {host_s:.2f} s per batch of 4 at 512^2 (JPEG off)")
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]
    state, d_step, g_step = make_gan_trainer(g, d, d_reg_every=16)
    init = {f"{m}.{k}": p.detach().clone() for m in ("g", "d")
            for k, p in getattr(state, m).named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps = []
    t_run = time.perf_counter()
    for pair in range(17):
        batch = batches[pair % 2]
        for kind, fn in (("d_r1" if state.step % 16 == 0 else "d", d_step), ("g", g_step)):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            steps.append(dict(pair=pair, kind=kind, ms=ms,
                              metrics={k: float(v) for k, v in m.items()},
                              launches={k: after[k] - before[k] for k in after}))
    run_s = time.perf_counter() - t_run
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for st in steps:
        if st["launches"] != want[st["kind"]]:
            fail(f"train pair {st['pair']} {st['kind']}: launches {st['launches']}, "
                 f"expected {want[st['kind']]}")
        if not all(math.isfinite(v) for v in st["metrics"].values()):
            fail(f"train pair {st['pair']} {st['kind']}: metrics {st['metrics']}")
    r1_steps = [st for st in steps if st["kind"] == "d_r1"]
    if [st["pair"] for st in r1_steps] != [0, 16] or not all(
            st["metrics"]["r1"] > 0 for st in r1_steps):
        fail(f"train: R1 ran at pairs {[st['pair'] for st in r1_steps]}, want 0 and 16")
    for name, count in launches.items():
        total = sum(st["launches"][name] for st in steps)
        print(f"train: {name} launches {count} on the main path (per R1 d_step "
              f"{want['d_r1'][name]}, per d_step {want['d'][name]}, per g_step "
              f"{want['g'][name]}; steps sum to {total})")
        if count == 0:
            fail(f"{name} never launched on the training path")
        elif count != total:
            fail(f"{name}: {count} launches, the steps sum to {total}")
    changed = {m: sum(not torch.equal(p, init[f"{m}.{k}"])
                      for k, p in getattr(state, m).named_parameters()) for m in ("g", "d")}
    ema_moved = sum(not torch.equal(p, init[f"g.{k}"]) for k, p in state.g_ema.named_parameters())
    n_g = len(list(state.g.parameters()))
    print(f"train: parameters changed G {changed['g']}/{n_g}, D {changed['d']}/"
          f"{len(list(state.d.parameters()))}; EMA moved {ema_moved}/{n_g}; step {state.step}")
    if changed["g"] == 0 or changed["d"] == 0 or ema_moved == 0 or state.step != 17:
        fail("train: the parameters or the EMA did not move")

    def mean(vals):
        return sum(vals) / len(vals)

    steady = [st for st in steps if 1 <= st["pair"] <= 15]
    d_ms = mean([st["ms"] for st in steady if st["kind"] == "d"])
    g_ms = mean([st["ms"] for st in steady if st["kind"] == "g"])
    pairs_per_s = 15 / (sum(st["ms"] for st in steady) / 1e3)
    r1_ms = steps[32]["ms"]  # pair 16's d_step
    last = steps[-1]["metrics"]
    print(f"train: R1 d_step (step 16) {r1_ms:.1f} ms; d_step {d_ms:.1f} ms, g_step "
          f"{g_ms:.1f} ms (means over pairs 1-15); {pairs_per_s:.3f} step pairs/s; "
          f"pair 0 (cuDNN warm-up) {steps[0]['ms']:.1f} + {steps[1]['ms']:.1f} ms; "
          f"17 pairs {run_s:.1f} s; peak {peak:.1f} GiB; last g_step {last}; {card}")
    per = dict(r1_d_step_ms=r1_ms, d_step_ms=d_ms, g_step_ms=g_ms, pairs_per_s=pairs_per_s,
               host_s_per_batch=host_s, peak_gib=peak, steps=steps, expected=want,
               profile=profile_g_step(torch, state, g_step, batches[0], g_ms))
    return launches, per


def profile_g_step(torch, state, g_step, batch, unprofiled_ms):
    """One more g_step under torch.profiler (after the launch counts were
    read): device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g_step(state, batch)
        torch.cuda.synchronize()
    return profile_rows(device_rows(prof), "one g_step", unprofiled_ms)


def run_train_cmd(torch, card, work, ckpt):
    """The ``train`` command at full width on the CLI phase's checkpoint
    directory (plus a random torchvision-layout vgg16.pth) and clip (phase
    9)."""
    from s2v_torch import cli
    from s2v_torch.models.enet import enet_arch
    from s2v_torch.models.vgg import VGG16Features
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.train import data as train_data
    from s2v_torch.train import finetune_enet
    from s2v_torch.train.finetune import init_state, make_optimizer, style_conv_mask
    from s2v_torch.utils.checkpoint import TrainCheckpointer
    from s2v_torch.utils.weights import load_reference, load_torch_checkpoint, merge_enet_lnet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cli.write_checkpoint_dir(ckpt, {"vgg16": VGG16Features()})
    timing = {"load_s": [], "batches_s": [], "steps": []}
    real = (cli.load_models, train_data.build_enet_batches,
            finetune_enet.make_enet_finetune_step)

    def load_models(*a, **k):
        t0 = time.perf_counter()
        m = real[0](*a, **k)
        torch.cuda.synchronize()
        timing["load_s"].append(time.perf_counter() - t0)
        return m

    def build(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[1](*a, **k)
        timing["batches_s"].append(time.perf_counter() - t0)
        return out

    def make_step(*a, **k):
        state, step = real[2](*a, **k)

        def timed(state, batch):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            after = launch_counts()
            timing["steps"].append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                        metrics={k: float(v) for k, v in m.items()},
                                        launches={k: after[k] - before[k] for k in after}))
            return state, m

        return state, timed

    tmp = work / "train_tmp"
    argv = ["train", "--face", str(work / "clip.npz"), "--audio", str(work / "speech.wav"),
            "--checkpoint_dir", ckpt, "--tmp_dir", str(tmp), "--train.batch_size", "4",
            "--train.epochs", "3"]
    cli.load_models, train_data.build_enet_batches = load_models, build
    finetune_enet.make_enet_finetune_step = make_step
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state = cli.main(argv)
    finally:
        cli.load_models, train_data.build_enet_batches = real[0], real[1]
        finetune_enet.make_enet_finetune_step = real[2]
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    sd = merge_enet_lnet(load_torch_checkpoint(str(Path(ckpt) / "ENet.pth")),
                         load_torch_checkpoint(str(Path(ckpt) / "LNet.pth")))
    with torch.device("cuda"):
        fresh = enet_arch(sd)
    fresh = load_reference(fresh, sd).cuda()
    after = state.module.state_dict()
    changed = sorted({k.split(".")[0] for k, t in fresh.state_dict().items()
                      if not torch.equal(t, after[k])})
    ckptr = TrainCheckpointer(str(tmp / "enet_ckpt"))
    restored = ckptr.restore(init_state(fresh, make_optimizer(1e-2, fresh, style_conv_mask)))
    bitwise = all(torch.equal(t, after[k]) for k, t in fresh.state_dict().items())
    steps = timing["steps"]
    finite = all(math.isfinite(v) for st in steps for v in st["metrics"].values())
    step_ms = [st["ms"] for st in steps]
    print(f"train command: {len(steps)} steps (state.step {state.step}); load_models "
          f"{sum(timing['load_s']):.2f} s, Steps 1-3 + batches "
          f"{wall - sum(timing['load_s']) - sum(step_ms) / 1e3:.2f} s (build_enet_batches "
          f"{sum(timing['batches_s']):.2f} s), synchronised ms per step "
          f"{', '.join(f'{ms:.1f}' for ms in step_ms)}; main {wall:.1f} s; peak {peak:.1f} GiB; "
          f"changed {changed}; checkpoints {ckptr.steps()}, restored step {restored.step} "
          f"bit for bit {bitwise}; launches {launches}; last metrics "
          f"{steps[-1]['metrics'] if steps else None}; {card}")
    if len(steps) != 6 or state.step != 6:
        fail(f"train command ran {len(steps)} steps (state.step {state.step}), want 6")
    if not finite:
        fail("train command: a loss is not finite")
    if changed != ["style_convs"]:
        fail(f"train command changed {changed}, want style_convs only")
    if not bitwise or restored.step != 6:
        fail("train command: the checkpoint does not restore the trained ENet bit for bit")
    if any(launches.values()) or any(any(st["launches"].values()) for st in steps):
        fail(f"train command launched kernels {launches}: ENet, VGG16 and ReconNet have none")
    return launches, dict(wall_s=wall, load_s=timing["load_s"], batches_s=timing["batches_s"],
                          steps=steps, peak_gib=peak, changed=changed,
                          checkpoints=ckptr.steps())


def finetune_models(torch, seed):
    """The slim ENet of the slim slice, VGG16 (fixed widths) and a slim
    ReconNet."""
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.resnet import ReconNet
    from s2v_torch.models.vgg import VGG16Features

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return (ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25, lnet_base_nc=8,
                     lnet_max_nc=32),
                VGG16Features(), ReconNet(layers=(1, 1, 1, 1), base_planes=8))


def phase_finetune_reference(torch):
    """One slim ENet fine-tune step with the VGG16 and ReconNet identity
    terms on the card and on the CPU from the same weights and batch, f32:
    metrics within rtol 1e-4, style-conv gradients within 5e-3 of each
    one's largest, updated style-conv parameters within 5e-3 of their
    scale (lr 1e-3: an entry whose gradient is within f32 noise of 0 may
    take Adam's first step the other way, 2e-3 apart), every other
    parameter and every buffer bit-equal to before the step, no kernel
    launched (phase 12)."""
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.train.finetune_enet import make_enet_finetune_step, make_id_embed_fn
    from s2v_torch.utils.config import TrainConfig

    enet, vgg, recon = finetune_models(torch, 4)
    rng = np.random.RandomState(4)
    batch = {"mel": rng.randn(2, 80, 16, 1).astype(np.float32),
             "face": rng.rand(2, 96, 96, 6).astype(np.float32),
             "ref": rng.rand(2, 96, 96, 3).astype(np.float32),
             "target": rng.rand(2, 384, 384, 3).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        e = copy.deepcopy(enet)
        before = {k: t.clone() for k, t in e.state_dict().items()}
        state, step = make_enet_finetune_step(
            e, TrainConfig(lr=1e-3), device=dev, vgg=copy.deepcopy(vgg),
            id_embed_fn=make_id_embed_fn(copy.deepcopy(recon).to(dev)))
        reset_launch_counts()
        state, m = step(state, batch)
        launches = launch_counts()
        after = {k: t.detach().cpu() for k, t in e.state_dict().items()}
        frozen = [k for k in after if not k.startswith("style_convs.")
                  and not torch.equal(after[k], before[k].cpu())]
        out[dev] = dict(metrics={k: float(v) for k, v in m.items()}, after=after,
                        grads={k: p.grad.detach().cpu() for k, p in e.named_parameters()
                               if p.grad is not None}, frozen_moved=frozen, launches=launches)
    cpu, card = out["cpu"], out["cuda"]
    worst = dict(metric=0.0, grad=0.0, param=0.0)
    for k, want in cpu["metrics"].items():
        worst["metric"] = max(worst["metric"], abs(card["metrics"][k] - want) / abs(want))
    if set(card["grads"]) != set(cpu["grads"]) or not cpu["grads"]:
        fail("finetune reference: the parameters with a gradient differ between the devices")
    for k, want in cpu["grads"].items():
        worst["grad"] = max(worst["grad"], (card["grads"][k] - want).abs().max().item()
                            / max(want.abs().max().item(), 1e-30))
    for k in cpu["grads"]:
        want = cpu["after"][k]
        worst["param"] = max(worst["param"], (card["after"][k] - want).abs().max().item()
                             / max(1.0, want.abs().max().item()))
    ok = (worst["metric"] <= 1e-4 and worst["grad"] <= 5e-3 and worst["param"] <= 5e-3
          and not cpu["frozen_moved"] and not card["frozen_moved"]
          and not any(card["launches"].values()))
    print(f"finetune reference: slim ENet + VGG16 + slim ReconNet, card vs CPU: metrics "
          f"{card['metrics']} (CPU {cpu['metrics']}), worst metric rel {worst['metric']:.2e} "
          f"(tol 1e-4), style-conv gradient err / scale {worst['grad']:.2e} (tol 5e-3), "
          f"updated parameters {worst['param']:.2e} (tol 5e-3), frozen moved "
          f"{card['frozen_moved'] + cpu['frozen_moved']}, launches {card['launches']} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("finetune reference: the card disagrees with the CPU")
    return worst


ROI_NAMES = ("left_eye", "right_eye", "mouth")
# The generator's Adam rate in the full-width GFPGAN phase. Adam's first
# steps move every entry by about lr; the JAX default 2e-3 is 0.2% of the
# equalized layers' N(0, 1) weights but some 20% of GFPGANv1Clean's plain
# convs' random Kaiming-scale ones (about 1e-2): one such step multiplied
# the random generator's output by some 3e5 and pair 2 went to NaN on an
# H100 (PERF.md, section 6). 2e-5 is the same 0.2% of those weights.
GFPGAN_G_LR = 2e-5


def gfpgan_nets(torch, size, seed, slim):
    """GFPGANv1Clean, the GPEN discriminator (channel multiplier 1, as
    GFPGAN's train_gfpgan_v1.yml sets its StyleGAN2Discriminator), three
    FacialComponentDiscriminators, VGG16 and IR-SE50 (frozen), random from
    ``seed``; slim: the generator and D at the slim slice's widths."""
    from s2v_torch.models.gfpgan import GFPGANv1Clean
    from s2v_torch.models.gpen import Discriminator
    from s2v_torch.models.irse import BackboneIRSE
    from s2v_torch.models.vgg import VGG16Features
    from s2v_torch.train.gfpgan_train import FacialComponentDiscriminator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = GFPGANv1Clean(out_size=size, **(dict(num_style_feat=64, channel_multiplier=0.5,
                                                 narrow=0.5) if slim else {}))
        d = Discriminator(size, channel_multiplier=1, narrow=0.25 if slim else 1.0)
        comps = {name: FacialComponentDiscriminator() for name in ROI_NAMES}
        vgg, irse = VGG16Features(), BackboneIRSE()
    return g, d, comps, vgg.eval().requires_grad_(False), irse.eval().requires_grad_(False)


def gfpgan_losses(torch, vgg, irse):
    """The perceptual term (VGG16 on images mapped to [0, 1]) and the
    identity embedding (IR-SE50 through ``id_loss_feats``) of the GFPGAN
    phases."""
    from s2v_torch.models.irse import id_loss_feats
    from s2v_torch.models.vgg import vgg_perceptual_loss

    def percep(fake, gt):
        return vgg_perceptual_loss(vgg, (fake + 1) / 2, (gt + 1) / 2)

    return percep, lambda x: id_loss_feats(irse, x)


def gfpgan_batch(size, n, seed, jitter):
    """``face_batches`` over synthetic faces, JPEG off, ``gt`` the high-
    quality side; ``loc_*`` the facexlib template's eyes and mouth-corner
    midpoint at ``size``, each jittered by up to ``jitter`` px. Returns the
    batch and its host seconds."""
    from s2v_torch.pipeline.restoration import FACEXLIB_TEMPLATE_512 as T

    batch, host_s = train_batches(size, n, n, 1, seed)
    batch = {"lq": batch[0]["lq"], "gt": batch[0]["hq"]}
    rng = np.random.RandomState(seed)
    for name, c in zip(ROI_NAMES, (T[0], T[1], (T[3] + T[4]) / 2)):
        batch[f"loc_{name}"] = (c * size / 512.0 + rng.uniform(-jitter, jitter, (n, 2))
                                ).astype(np.float32)
    return batch, host_s


def phase_gfpgan_reference(torch):
    """One g_step and one d_step of ``make_gfpgan_trainer`` at slim widths
    (GFPGANv1Clean and GPEN D at 64^2, the component discriminators on 16^2
    crops, VGG16 and IR-SE50 at their widths) on the card and on the CPU,
    each step from the CPU's parameters of the moment: metrics within rtol
    1e-3, every parameter gradient within 5e-3 of that parameter's largest,
    and the card's launches equal to ``expected_gfpgan_launches`` (phase
    13)."""
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.train.gan import expected_gfpgan_launches
    from s2v_torch.train.gfpgan_train import make_gfpgan_trainer

    g, d, comps, vgg, irse = gfpgan_nets(torch, 64, 5, slim=True)
    want_launches = expected_gfpgan_launches(g, d, comps)
    batch, _ = gfpgan_batch(64, 2, 5, jitter=2.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        percep, embed = gfpgan_losses(torch, copy.deepcopy(vgg).to(dev),
                                      copy.deepcopy(irse).to(dev))
        runs[dev] = make_gfpgan_trainer(copy.deepcopy(g), copy.deepcopy(d),
                                        copy.deepcopy(comps), device=dev, vgg_loss_fn=percep,
                                        id_embed_fn=embed,
                                        roi_sizes=dict.fromkeys(ROI_NAMES, 16))
    worst, worst_metric, launches = 0.0, 0.0, {}
    for kind in ("g", "d"):
        ref = runs["cpu"][0]
        for mod in ("g", "d", "comps"):
            getattr(runs["cuda"][0], mod).load_state_dict(getattr(ref, mod).state_dict())
        out = {}
        for dev, (state, g_step, d_step) in runs.items():
            reset_launch_counts()
            _, m = (g_step if kind == "g" else d_step)(state, batch)
            launches[dev] = launch_counts()
            mods = [("g", state.g)] if kind == "g" else [("d", state.d), ("comps", state.comps)]
            out[dev] = ({k: float(v) for k, v in m.items()},
                        {f"{n}.{k}": None if p.grad is None else p.grad.detach().cpu()
                         for n, mod in mods for k, p in mod.named_parameters()})
        (m_cpu, g_cpu), (m_dev, g_dev) = out["cpu"], out["cuda"]
        for k in m_cpu:
            rel = abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
            worst_metric = max(worst_metric, rel)
            if rel > 1e-3:
                fail(f"gfpgan reference {kind}: metric {k} card {m_dev[k]} vs CPU {m_cpu[k]}")
        for k, want in g_cpu.items():
            got = g_dev[k]
            if (got is None) != (want is None):
                fail(f"gfpgan reference {kind}: {k} has a gradient on one device only")
                continue
            if want is None:
                continue
            ratio = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
            worst = max(worst, ratio)
            if not ratio <= 5e-3:
                fail(f"gfpgan reference {kind}: gradient of {k} off by {ratio:.2e} of its scale")
        if launches["cuda"] != want_launches[kind]:
            fail(f"gfpgan reference {kind}: launches {launches['cuda']}, expected "
                 f"{want_launches[kind]}")
        print(f"gfpgan reference {kind}_step: metrics {m_dev} (CPU {m_cpu}); launches "
              f"{launches['cuda']} (expected {want_launches[kind]})")
    print(f"gfpgan reference: slim GFPGANv1Clean-64 + GPEN D + 3 component Ds, card vs CPU, "
          f"worst metric rel {worst_metric:.2e} (tol 1e-3), worst gradient err / scale "
          f"{worst:.2e} (tol 5e-3) {'ok' if worst <= 5e-3 and worst_metric <= 1e-3 else 'FAIL'}")
    return dict(worst_grad_ratio=worst, worst_metric_rel=worst_metric,
                expected_launches=want_launches)


def phase_gfpgan_train(torch, card):
    """GFPGAN training at full width (phase 14): GFPGANv1Clean(512), GPEN
    Discriminator(512, channel_multiplier=1), the three component
    discriminators at the JAX defaults' crops (eyes 80, mouth 120), VGG16
    perceptual and IR-SE50 identity terms, random weights from seed 0, f32
    without TF32; batch 3 at 512^2, step pairs 0-4 (g_step, then d_step).
    Every step's launches must equal ``expected_gfpgan_launches``."""
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
    from s2v_torch.train.gan import expected_gfpgan_launches
    from s2v_torch.train.gfpgan_train import make_gfpgan_trainer

    t = time.perf_counter()
    g, d, comps, vgg, irse = gfpgan_nets(torch, 512, 0, slim=False)
    want = expected_gfpgan_launches(g, d, comps)

    def params(m):
        return sum(p.numel() for p in m.parameters()) / 1e6

    print(f"gfpgan train: built GFPGANv1Clean(512) ({params(g):.1f}M params), D "
          f"({params(d):.1f}M), 3 component Ds ({params(comps['mouth']):.2f}M each), VGG16 "
          f"({params(vgg):.1f}M), IR-SE50 ({params(irse):.1f}M) in {time.perf_counter() - t:.1f} "
          f"s; launches per step derived from the modules: {want}")
    batch, host_s = gfpgan_batch(512, 3, 0, jitter=8.0)
    batch = {k: torch.as_tensor(v).cuda() if k in ("lq", "gt") else v for k, v in batch.items()}
    percep, embed = gfpgan_losses(torch, vgg.cuda(), irse.cuda())
    state, g_step, d_step = make_gfpgan_trainer(g, d, comps, vgg_loss_fn=percep,
                                                id_embed_fn=embed, g_lr=GFPGAN_G_LR)
    init = {f"{m}.{k}": p.detach().clone() for m in ("g", "d", "comps")
            for k, p in getattr(state, m).named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps = []
    t_run = time.perf_counter()
    for pair in range(5):
        for kind, fn in (("g", g_step), ("d", d_step)):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            steps.append(dict(pair=pair, kind=kind, ms=ms,
                              metrics={k: float(v) for k, v in m.items()},
                              launches={k: after[k] - before[k] for k in after}))
    run_s = time.perf_counter() - t_run
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in steps:
        if st["launches"] != want[st["kind"]]:
            fail(f"gfpgan train pair {st['pair']} {st['kind']}_step: launches "
                 f"{st['launches']}, expected {want[st['kind']]}")
        if not all(math.isfinite(v) for v in st["metrics"].values()):
            fail(f"gfpgan train pair {st['pair']} {st['kind']}_step: metrics {st['metrics']}")
    for name, count in launches.items():
        print(f"gfpgan train: {name} launches {count} (per g_step {want['g'][name]}, per "
              f"d_step {want['d'][name]})")
        if count == 0:
            fail(f"{name} never launched on the GFPGAN training path")
    changed = {m: sum(not torch.equal(p, init[f"{m}.{k}"])
                      for k, p in getattr(state, m).named_parameters())
               for m in ("g", "d", "comps")}
    print(f"gfpgan train: parameters changed {changed}; step {state.step}")
    if not all(changed.values()) or state.step != 5:
        fail("gfpgan train: a model's parameters did not move, or step != 5")

    def mean(vals):
        return sum(vals) / len(vals)

    steady = [st for st in steps if st["pair"] >= 1]
    g_ms = mean([st["ms"] for st in steady if st["kind"] == "g"])
    d_ms = mean([st["ms"] for st in steady if st["kind"] == "d"])
    pairs_per_s = len(steady) / 2 / (sum(st["ms"] for st in steady) / 1e3)
    print(f"gfpgan train: g_step {g_ms:.1f} ms, d_step {d_ms:.1f} ms (means over pairs 1-4); "
          f"{pairs_per_s:.3f} step pairs/s; pair 0 (cuDNN warm-up) {steps[0]['ms']:.1f} + "
          f"{steps[1]['ms']:.1f} ms; 5 pairs {run_s:.1f} s; peak {peak:.1f} GiB; face_batches "
          f"host {host_s:.2f} s for the batch of 3 at 512^2; last g_step {steps[-2]['metrics']}; "
          f"{card}")
    per = dict(g_step_ms=g_ms, d_step_ms=d_ms, pairs_per_s=pairs_per_s, peak_gib=peak,
               host_s_per_batch=host_s, steps=steps, expected=want,
               profile=profile_g_step(torch, state, g_step, batch, g_ms))
    return launches, per


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels (phases 1 and 2), nothing else")
    parser.add_argument("--package", type=Path,
                        help="directory holding the s2v_torch package to use")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.package is not None:
        sys.path.insert(0, str(args.package.resolve()))
    import s2v_torch  # (fails outside a checkout of the repo)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; {card}", flush=True)

    print(f"package {Path(s2v_torch.__file__).parent}")

    t_start = time.perf_counter()
    report = {"card": card, "build_s": phase_build()}
    cases = phase_kernels(torch)
    report["kernel_cases"] = cases
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if args.kernels_only:
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(report, indent=1))
        print(f"kernels only: {len(FAILURES)} failure(s)")
        return 1 if FAILURES else 0
    report["reference"] = phase_reference(torch)
    report["steps_reference"] = phase_steps_reference(torch)
    report["retina_reference"] = phase_retina_reference(torch)
    report["mouth_reference"] = phase_mouth_reference(torch, card)
    report["options_reference"] = phase_options_reference(torch)
    launches, report["slice"] = phase_slice(torch, card)
    torch.cuda.empty_cache()
    (cli_launches, report["cli"], (cmd_launches, report["train_cmd"]),
     (opt_launches, report["infer_options"]),
     (mesh_launches, report["infer_mesh"])) = phase_cli(torch, card)
    torch.cuda.empty_cache()
    report["train_reference"] = phase_train_reference(torch)
    train_launches, report["train"] = phase_train(torch, card)
    torch.cuda.empty_cache()
    report["finetune_reference"] = phase_finetune_reference(torch)
    report["gfpgan_reference"] = phase_gfpgan_reference(torch)
    gfpgan_launches, report["gfpgan_train"] = phase_gfpgan_train(torch, card)
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    import torch.distributed as dist

    work = Path(tempfile.mkdtemp(prefix="s2v_dist_"))
    init_nccl(torch, work)
    try:
        t = time.perf_counter()
        gan_dp_launches, report["gan_dp"] = phase_gan_dp(torch, card, work)
        report["gan_dp"]["wall_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        report["arcface"] = phase_arcface(torch, card)
        report["arcface"]["wall_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_start
    paths = dict(slice=launches, cli=cli_launches, infer_options=opt_launches,
                 infer_mesh=mesh_launches, train=train_launches, train_cmd=cmd_launches,
                 gfpgan_train=gfpgan_launches, gan_dp=gan_dp_launches)

    def main_case(name, dtype):  # the first case at a main path's largest shape
        return next(c for c in cases if c["kernel"] == name and c["dtype"] == dtype)

    kernels = []
    for name, source, replaces, dtype in (
            ("fused_act", "s2v_torch/csrc/fused_act.cu", "s2v_tpu/ops/pallas/fused_act.py:63",
             "bfloat16"),
            ("fused_act_bwd", "s2v_torch/csrc/fused_act.cu",
             "s2v_tpu/ops/pallas/fused_act.py:88", "float32"),
            ("upfirdn2d", "s2v_torch/csrc/upfirdn2d.cu",
             "s2v_tpu/ops/pallas/upfirdn2d.py:174", "bfloat16")):
        c = main_case(name, dtype)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(path[name] for path in paths.values()),
            launches_by_path={k: path[name] for k, path in paths.items()},
            max_abs_err=max(k["max_abs_err"] for k in cases if k["kernel"] == name),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], shape=c["shape"],
            dtype=dtype))
    # K3 also at GPEN-512 training's largest forward shape, in f32
    t = next(c for c in cases if c["kernel"] == "upfirdn2d" and c.get("role") == "forward")
    kernels[-1]["train_case"] = {k: t[k] for k in ("shape", "dtype", "pad", "ms", "plain_ms",
                                                   "bound_ms", "library_ms")}
    # each kernel at the component discriminators' largest shape (GFPGAN training)
    for k in kernels:
        c = next(c for c in cases if c["kernel"] == k["name"] and c.get("path") == "gfpgan")
        k["gfpgan_case"] = {f: c[f] for f in ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")}
    # K1 and K3 at GFPGANv1(512)'s largest shapes in the mouth tail (phase 15)
    for k in kernels:
        c = next((c for c in cases if c["kernel"] == k["name"]
                  and c.get("path") == "infer_options"), None)
        if c is not None:
            k["gfpgan_v1_case"] = {f: c[f] for f in ("shape", "dtype", "max_abs_err", "ms",
                                                     "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")}
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"total {report['seconds']:.1f} s")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
