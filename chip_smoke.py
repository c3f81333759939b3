"""Quickest proof that the s2v_torch port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits nonzero without the
result line:

1. build: compile every CUDA kernel of the port from s2v_torch/csrc (one
   nvcc per source, all started together) and print the build seconds and
   each kernel's register use.
2. kernels: call each kernel's wrapper at the shapes GPEN-BFR-2048 gives it
   on the main path (plus a down=2 and a negative-pad upfirdn2d case) and
   hold it against its plain PyTorch version, in f32 and bf16; print the
   error against its tolerance, the kernel, plain and library times (CUDA
   events) and the least time the card could take.
3. reference: the slice at slim widths on the card (kernels) and on the CPU
   (plain versions), f32, must agree on the output frames.
4. slice: the full-width models (ENet/LNet defaults, GPEN-BFR-2048,
   ParseNet, RealESRNet x2) with random weights from a fixed seed run
   ``melspectrogram`` -> ``LipSyncPipeline.synthesize`` with the final hook
   on 8 synthetic 512x512 frames and 0.4 s of synthetic speech. The launch
   counts are reset just before this run and read just after; each kernel
   must have run, 38 and 27 times per frame.

The line before the last is one JSON object with every kernel's numbers;
the last is ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json. TF32 is off throughout (f32 convs and matmuls
run in full f32).
"""

from __future__ import annotations

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


def event_ms(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    from s2v_torch.ops.kernels import _build

    t = time.perf_counter()
    _build.build(["fused_act", "upfirdn2d"])
    secs = time.perf_counter() - t
    print(f"build: {secs:.1f} s (nvcc, sm_90a, both kernels in parallel)")
    for name in ("fused_act", "upfirdn2d"):
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return secs


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
                        ms=event_ms(torch, lambda: fused_bias_leaky_relu(x, b)),
                        plain_ms=event_ms(torch, lambda: fused_bias_leaky_relu_plain(x, b)),
                        bound_ms=bms, bound_by=by, library_ms=None)
            cases.append(case)
            del x, got, want

    # K3: the GPEN-2048 configurations, a down=2 case and a negative pad
    blur = make_kernel(BLUR_TAPS)
    k3 = [((1, 16, 2049, 2049), 1, 1, (1, 1), blur * 4),  # after each transposed conv
          ((1, 16, 2048, 2048), 1, 1, (2, 2), blur),      # before a stride-2 encoder conv
          ((1, 3, 1024, 1024), 2, 1, (2, 1), blur * 4),   # ToRGB skip upsample
          ((1, 16, 2048, 2048), 1, 2, (1, 1), blur),      # StyleGAN2 downsample
          ((1, 16, 1024, 1024), 1, 1, (-1, 2), blur)]     # negative pad crops
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
                        ms=event_ms(torch, lambda: upfirdn2d(x, fir, up, down, pad)),
                        plain_ms=event_ms(torch, lambda: upfirdn2d_plain(x, fir, up, down, pad)),
                        bound_ms=bms, bound_by=by,
                        library_ms=event_ms(torch, lambda: F.conv2d(
                            xp, w, stride=down, groups=shape[1])))
            cases.append(case)
            del x, xp, got, want

    for c in cases:
        ok = c["max_abs_err"] <= c["tol"]
        extra = (f" up={c['up']} down={c['down']} pad={tuple(c['pad'])}"
                 if c["kernel"] == "upfirdn2d" else "")
        lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"kernel {c['kernel']} {tuple(c['shape'])} {c['dtype']}{extra}: "
              f"max_abs_err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
              f"{'ok' if ok else 'FAIL'}; ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
              f"library {lib} bound {c['bound_ms']:.4f} ({c['bound_by']})")
        if not ok:
            fail(f"{c['kernel']} {c['shape']} {c['dtype']} disagrees with its plain version")
    return cases


def slim_models(torch):
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.models.rrdbnet import RRDBNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        return dict(enet=ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
                              lnet_base_nc=8, lnet_max_nc=32),
                    facegan=FullGenerator(size=64, narrow=0.25, channel_multiplier=0.5,
                                          style_dim=64, n_mlp=2),
                    parsenet=ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=2),
                    srmodel=RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8))


def full_models(torch):
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.models.rrdbnet import RRDBNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return dict(enet=ENet(), facegan=FullGenerator(size=2048),
                    parsenet=ParseNet(),
                    srmodel=RRDBNet(scale=2, num_feat=32, num_block=23, num_grow_ch=32))


def make_pipeline(models, in_size, dtype, parse_size, device, batch=16):
    from s2v_torch.pipeline.enhance import FaceEnhancer, final_enhancer_hook
    from s2v_torch.pipeline.inference import LipSyncPipeline, PipelineModels
    from s2v_torch.utils.config import InferenceConfig, ModelConfig, PipelineConfig

    final = FaceEnhancer({k: models[k] for k in ("facegan", "parsenet", "srmodel")},
                         in_size=in_size, dtype=dtype, parse_size=parse_size, device=device)
    cfg = PipelineConfig(model=ModelConfig(dtype=dtype, reuse_detections=True),
                         infer=InferenceConfig(lnet_batch_size=batch))
    hook = final_enhancer_hook(final)
    return LipSyncPipeline(cfg, PipelineModels(enet=models["enet"], final_enhancer=hook),
                           device=device), hook


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
        pipe, _ = make_pipeline(copy.deepcopy(models), 64, "float32", 128, device, batch=4)
        outs[device] = run_slice(torch, pipe, x, device)
    d = np.abs(outs["cuda"].astype(np.int32) - outs["cpu"].astype(np.int32))
    share = float((d > 1).mean())
    ok = outs["cuda"].shape == (6, 192, 224, 3) and share <= 1e-3 and d.mean() < 0.01
    print(f"reference: slim slice card vs CPU, output {outs['cuda'].shape}: max diff "
          f"{d.max()}, share > 1 gray level {share:.2e} (tol 1e-3), mean {d.mean():.4f} "
          f"(tol 0.01) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("slim slice on the card disagrees with the CPU")
    return dict(max_diff=int(d.max()), share_over_1=share, mean=float(d.mean()))


def phase_slice(torch, card):
    from s2v_torch.audio import melspectrogram
    from s2v_torch.ops.kernels import launch_counts, reset_launch_counts

    t = time.perf_counter()
    models = full_models(torch)
    pipe, hook = make_pipeline(models, 2048, "bfloat16", 512, "cuda")
    print(f"slice: built full-width models in {time.perf_counter() - t:.1f} s "
          f"(GPEN-BFR-2048 {sum(p.numel() for p in models['facegan'].parameters()) / 1e6:.1f}M "
          f"params, ENet {sum(p.numel() for p in models['enet'].parameters()) / 1e6:.1f}M, "
          f"ParseNet {sum(p.numel() for p in models['parsenet'].parameters()) / 1e6:.1f}M, "
          f"RRDBNet {sum(p.numel() for p in models['srmodel'].parameters()) / 1e6:.1f}M)")
    x = clip_inputs(8, 512, 512, 0.4, seed=0)

    stages = {"enet_batch": [], "final": []}

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    pipe._step6 = timed(pipe._step6, "enet_batch")
    pipe.models.final_enhancer = timed(hook, "final")

    run_slice(torch, pipe, x, "cuda")  # warm-up: cuDNN plans, allocator
    for v in stages.values():
        v.clear()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = torch.from_numpy(x["wav"]).cuda()
    mel = melspectrogram(wav)
    torch.cuda.synchronize()
    mel_ms = (time.perf_counter() - t0) * 1e3
    out = pipe.synthesize(x["stab"], mel, x["frames"], x["coords"], 25.0,
                          boxes_full=x["boxes"], lms_full=x["lms_full"],
                          lms_stab=x["lms_stab"])
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    from s2v_torch.audio.melspec import num_mel_chunks

    n = num_mel_chunks(mel.shape[1], 25.0)
    ok_shape = out.shape == (n, 1024, 1024, 3) and out.dtype == np.uint8
    std = float(out.astype(np.float32).std())
    print(f"slice: output {out.shape} {out.dtype}, std {std:.2f}, mel {tuple(mel.shape)}, "
          f"{n} chunks; {'ok' if ok_shape and std > 0 else 'FAIL'}")
    if not ok_shape:
        fail(f"slice output {out.shape} {out.dtype}, want ({n}, 1024, 1024, 3) uint8")
    if not std > 0:
        fail("slice output is constant")
    want = {"fused_act": 38 * n, "upfirdn2d": 27 * n}
    for name, count in launches.items():
        print(f"slice: {name} launches {count} on the main path "
              f"({count / n:.1f} per frame; expected {want[name] // n})")
        if count == 0:
            fail(f"{name} never launched on the main path")
        elif count != want[name]:
            fail(f"{name} launched {count} times, expected {want[name]}")
    per = dict(mel_ms=mel_ms, enet_batch_ms=list(stages["enet_batch"]),
               final_per_frame_ms=sum(stages["final"]) / n, total_ms=total_ms,
               frames_per_s=n / total_ms * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"slice: mel {mel_ms:.1f} ms; ENet per batch "
          f"{', '.join(f'{v:.1f}' for v in stages['enet_batch'])} ms; final stage "
          f"{per['final_per_frame_ms']:.1f} ms/frame; synthesize total {total_ms:.1f} ms "
          f"({per['frames_per_s']:.2f} frames/s); peak {per['peak_gib']:.1f} GiB; {card}")
    per["profile"] = profile_slice(torch, pipe, x, total_ms)
    return launches, per


def profile_slice(torch, pipe, x, unprofiled_ms):
    """One more run of the slice under torch.profiler (after the launch
    counts were read): device time by kernel, and the device's busy share of
    the unprofiled run's wall time (the profiler itself slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_slice(torch, pipe, x, "cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    rows.sort(key=dev_us, reverse=True)
    top = [dict(name=e.key[:90], calls=e.count, ms=dev_us(e) / 1e3) for e in rows[:15]]
    if busy_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
    else:
        print(f"profile: one slice run: device busy {busy_ms:.1f} ms, "
              f"{100 * busy_ms / unprofiled_ms:.1f}% of the unprofiled wall "
              f"{unprofiled_ms:.1f} ms (wall under the profiler {wall_ms:.1f} ms)")
        for r in top[:10]:
            print(f"  {r['ms']:8.2f} ms {r['calls']:5d}x  {r['name']}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                busy_share=busy_ms / unprofiled_ms, top=top)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import s2v_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t_start = time.perf_counter()
    report = {"card": card, "build_s": phase_build()}
    cases = phase_kernels(torch)
    report["kernel_cases"] = cases
    report["reference"] = phase_reference(torch)
    launches, report["slice"] = phase_slice(torch, card)
    report["seconds"] = time.perf_counter() - t_start

    def main_case(name, dtype):  # the main path's largest shape, in bf16
        return next(c for c in cases if c["kernel"] == name and c["dtype"] == dtype)

    kernels = []
    for name, source, replaces in (
            ("fused_act", "s2v_torch/csrc/fused_act.cu", "s2v_tpu/ops/pallas/fused_act.py:63"),
            ("upfirdn2d", "s2v_torch/csrc/upfirdn2d.cu",
             "s2v_tpu/ops/pallas/upfirdn2d.py:174")):
        c = main_case(name, "bfloat16")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(k["max_abs_err"] for k in cases if k["kernel"] == name),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], shape=c["shape"]))
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
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
