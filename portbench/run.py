#!/usr/bin/env python3
"""The benchmark of the s2v_torch port on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: set-up (load, warm up), a measured window
of ``--seconds``, then the check of the window's outputs against the plain
reference, and prints one JSON line last on standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` the per-layer metrics, from spans around the program's calls
and a profiled part of the window. Exits nonzero without a result when no
CUDA card is present, when the cell asks for more cards than there are, or
when JAX or the JAX package was loaded. See portbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "s2v_tpu")
GiB = 2 ** 30


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``s2v_torch`` is not ``s2v_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries that would load JAX by themselves kept from it; one
    intra-op thread on the host, so that idle worker threads do not spin
    beside the thread that drives the card."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    from portbench.core import registry

    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        say(f"{cell['name']} needs {cell['chips']} cards, {torch.cuda.device_count()} present")
        return 2
    import s2v_torch  # noqa: F401  (the program; absent from a bare copy of the benchmark)

    torch.set_num_threads(1)

    out = execute(args, bench, cell, "cuda", torch)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


def execute(args, bench, cell, device, torch, sizes=None, cache=CACHE):
    """Set-up, window and check of one cell on ``device`` ("cuda"; the
    tests pass "cpu" and slim ``sizes``); returns the result line's object,
    or None when JAX was loaded."""
    from portbench.core import registry

    cfg_sizes, cfg = registry.config(cell["config"])
    sizes = cfg_sizes if sizes is None else sizes
    traffic = registry.traffic(cell["traffic"])
    drv = registry.driver(traffic["driver"])
    tf32 = bool(sizes.get("tf32", sizes.get("pipeline", {}).get("tf32", False)))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        return run(args, bench, cell, sizes, cfg, traffic, registry.limits(cell["name"]), drv,
                   work, torch, device, cache)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, bench, cell, sizes, cfg, traffic, limits, drv, work, torch, device, cache):
    from portbench.core import registry
    from portbench.core.trace import TraceData, read, synchronize

    name = cell["name"]
    on_card = torch.device(device).type == "cuda"

    def peak() -> int:
        return torch.cuda.max_memory_allocated() if on_card else 0

    driver = drv.Driver(torch, sizes, cfg, traffic, args.seed, args.seconds, device, work, cache)
    driver.setup()
    synchronize(torch, device)
    setup_peak = peak()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    res = driver.window(args.seconds, bool(args.trace))
    synchronize(torch, device)
    window_peak = peak()
    found = forbidden_modules()
    if found:
        say(f"loaded after the window: {', '.join(found)}")
        return None
    name_of = torch.cuda.get_device_name(0) if on_card else "cpu"
    say(f"{name}: set-up {setup_s:.4f} s; window {res['wall_s']:.4f} s; {res['units']} "
        f"{res['unit']} in {res['attempted']} {'requests' if res['unit'] == 'frames' else 'pairs'}"
        f" ({res['failed']} failed); peak in the window {window_peak / GiB:.4f} GiB, in set-up "
        f"{setup_peak / GiB:.4f} GiB; {name_of}")
    say(f"{name}: {json.dumps(driver.info, default=str)}")
    device_info = dict(platform="gpu" if on_card else "cpu", kind=name_of, count=cell["chips"],
                       memory_peak_bytes=int(max(setup_peak, window_peak)))
    out = dict(correct=False, attempted=res["attempted"], failed=res["failed"])
    if args.trace:
        prof = None if res["profile"] is None else read(res["profile"], res["profiled_units"])
        td = TraceData(res["wall_s"], res["span_units"], res["spans"], prof, res["twin_s"])
        if res["twin_s"]:
            td.flop_s_at_peak = driver.flop_s_at_peak()
            say(f"{name}: the profiled work's unprofiled twin took {res['twin_s']:.4f} s; ideal "
                f"{td.flop_s_at_peak:.6f} s at the peaks")
        if prof is not None:
            device_info.update(busy_s=prof.busy_s(), window_s=prof.window_s)
            out["breakdown"] = dict(device_ops=prof.device_ops(), idle_gaps=prof.idle_gaps())
            say(f"{name}: profiled {prof.units} {res['unit']} over {prof.window_s:.4f} s, "
                f"{len(prof.device)} device operations, busy {prof.busy_s():.4f} s")
        say(f"{name}: spans over {res['span_units']} {res['unit']} outside the profile and twin")
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {}
        for metric, reader in registry.layer_metrics(bench, name).items():
            value = reader.read(td)
            if value is not None:
                metrics[metric] = dict(value=value, unit=units[metric])
            say(f"{name}: {metric} = {value} ({reader.BASE})")
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {drv.END_TO_END: dict(value=res["metric"], unit=units[drv.END_TO_END]),
                   "peak_mem_gib": dict(value=window_peak / GiB, unit="GiB"),
                   "setup_s": dict(value=setup_s, unit="s")}
    driver.free()
    numbers = driver.check()
    synchronize(torch, device)
    found = forbidden_modules()
    if found:
        say(f"loaded by the end of the run: {', '.join(found)}")
        return None
    compared = {k: dict(value=v, limit=limits.get(k)) for k, v in numbers.items()}
    out["correct"] = bool(numbers) and res["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values())
    out.update(metrics=metrics, device=device_info)
    say(f"{name}: wrote {driver.bytes_written} bytes to disk; the run took "
        f"{time.perf_counter() - T_START:.1f} s")
    for k, c in compared.items():
        say(f"compared {k} = {c['value']!r} (limit {c['limit']!r})")
    out["compared"] = compared
    return out


if __name__ == "__main__":
    sys.exit(main())
