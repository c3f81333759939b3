"""FAN (2DFAN4, 4 modules, 256 features) alone on the card: which cuDNN
route runs its f32 convolutions fastest, without TF32.

Routes: ``heuristic`` (cuDNN's heuristics choose each convolution's
algorithm, NCHW), ``timed`` (``cudnn.benchmark``: cuDNN times the
candidates per shape), ``cl_heuristic`` and ``cl_timed`` (the same with the
weights and the input in ``channels_last``). Each route runs in a process
of its own, since cuDNN's plan cache is per process. Per batch (32, 18 and
15 crops of 256^2, as the landmark sweeps send them): the first call's wall
(the autotuner's trials under ``timed``), the steady ms per call over CUDA
events, the peak of allocated memory in steady state, the top device
kernels of one profiled call at batch 32, and each route's heatmaps against
``heuristic``'s and the CPU's, over the largest heatmap magnitude.

    python3 tools/fan_conv_probe.py [--out build/fan_conv_probe.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s2v_torch.models.fan import FAN  # noqa: E402

ROUTES = ("heuristic", "timed", "cl_heuristic", "cl_timed")
BATCHES = (32, 18, 15)
REPEATS = 10


def fan_model(seed: int = 0) -> FAN:
    """Full-width FAN with random weights and BatchNorm statistics that are
    not the identity."""
    torch.manual_seed(seed)
    fan = FAN(num_modules=4).eval()
    g = torch.Generator().manual_seed(seed + 1)
    for m in fan.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.rand(n, generator=g) * 0.2 - 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            m.weight.data.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.data.copy_(torch.rand(n, generator=g) * 0.2 - 0.1)
    return fan


def crops(batch: int) -> torch.Tensor:
    return torch.rand(batch, 3, 256, 256, generator=torch.Generator().manual_seed(batch))


def run_route(route: str, out_dir: str) -> dict:
    dev = torch.device("cuda")
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.benchmark = route.endswith("timed")
    fmt = torch.channels_last if route.startswith("cl_") else torch.contiguous_format
    fan = fan_model().to(dev).to(memory_format=fmt)
    res = {"route": route, "batches": {}}
    with torch.no_grad():
        for b in BATCHES:
            x = crops(b).to(dev).contiguous(memory_format=fmt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hm = fan(x)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            for _ in range(2):
                fan(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPEATS):
                fan(x)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / REPEATS
            res["batches"][b] = dict(first_call_s=first_s, ms_per_call=ms, ms_per_face=ms / b,
                                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.save(hm.float().contiguous().cpu(), os.path.join(out_dir, f"{route}_{b}.pt"))
        from torch.profiler import ProfilerActivity, profile
        x = crops(32).to(dev).contiguous(memory_format=fmt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fan(x)
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                      key=lambda e: -e.device_time_total)
        res["top_kernels_b32"] = [(e.key[:90], round(e.device_time_total / 1e3, 3), e.count)
                                  for e in rows if not e.key.startswith("aten::")][:8]
    if route == "heuristic":
        # cuDNN's plan cache across the flag: the timed choice after the
        # heuristic one, in the same process and at the same shape
        cudnn.benchmark = True
        x = crops(32).to(dev)
        with torch.no_grad():
            fan(x)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPEATS):
                fan(x)
            end.record()
            torch.cuda.synchronize()
        res["timed_after_heuristic_ms_b32"] = start.elapsed_time(end) / REPEATS
    return res


def flops_per_face() -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        fan = FAN(num_modules=4).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fan(torch.empty(1, 3, 256, 256, device="meta"))
    return counter.get_total_flops()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--route", choices=ROUTES)
    p.add_argument("--dir")
    p.add_argument("--out", default="build/fan_conv_probe.json")
    a = p.parse_args()
    if a.route:
        print(json.dumps(run_route(a.route, a.dir)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("fan_conv_probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version(), "gflop_per_face": flops_per_face() / 1e9,
           "routes": {}, "vs_heuristic": {}, "vs_cpu": {}}
    with tempfile.TemporaryDirectory() as d:
        for route in ROUTES:
            r = subprocess.run([sys.executable, __file__, "--route", route, "--dir", d],
                               capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"{route} failed:\n{r.stderr[-4000:]}")
            out["routes"][route] = json.loads(r.stdout.strip().splitlines()[-1])
            print(route, json.dumps(out["routes"][route]), flush=True)
        fan = fan_model()
        torch.set_num_threads(os.cpu_count() or 1)
        for b in (32, 18):
            with torch.no_grad():
                want = fan(crops(b))
            scale = want.abs().max().item()
            base = torch.load(os.path.join(d, f"heuristic_{b}.pt"))
            for route in ROUTES:
                got = torch.load(os.path.join(d, f"{route}_{b}.pt"))
                out["vs_heuristic"][f"{route}_{b}"] = (got - base).abs().max().item() / scale
                out["vs_cpu"][f"{route}_{b}"] = (got - want).abs().max().item() / scale
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    summary = {r: {b: round(v["batches"][str(b)]["ms_per_face"], 3) for b in BATCHES}
               for r, v in out["routes"].items()}
    print(json.dumps({"card": smi, "gflop_per_face": out["gflop_per_face"],
                      "ms_per_face": summary, "vs_heuristic": out["vs_heuristic"],
                      "vs_cpu": out["vs_cpu"]}))


if __name__ == "__main__":
    main()
