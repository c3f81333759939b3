#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: the program against the plain reference over many seeds (sound
runs), the control (the reference one precision below the configuration's,
against the reference) and the faults that a run can have, planted in the
program, over a few seeds each.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... [--controls 3]

Prints one JSON object per reading, and each cell's summary last: the
largest sound reading and the smallest control and fault readings of every
number compared. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(out, **row):
    line = json.dumps(row, default=float)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def summarise(rows):
    by = {}
    for r in rows:
        for k, v in r["numbers"].items():
            by.setdefault(r["kind"], {}).setdefault(k, []).append(v)
    return {kind: {k: dict(max=max(v), min=min(v), n=len(v)) for k, v in nums.items()}
            for kind, nums in by.items()}


def halved(step):
    """A step that leaves out half of the batch, the mean taken over the
    rest."""
    return lambda state, batch: step(state, {k: v[: len(v) // 2] for k, v in batch.items()})


# faults planted in the program's trainer: which of (d_step, g_step) drop half the batch
HALVED = {"fault_half_batch": (True, True), "fault_half_batch_d": (True, False),
          "fault_half_batch_g": (False, True)}


def train(torch, cell, sizes, cfg, traffic, drv, seeds, controls, out):
    """Sound runs, the TF32 control and the half-batch faults (in both
    steps, in d_step alone, in g_step alone) of a training cell; the fault
    of a step that leaves the state unchanged reads 1 by the change's
    measure and needs no run."""
    from portbench.core import synth

    rows = []
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        weights = cfg.make_weights(torch, sizes, synth.stream(seed, 1), "cuda")
        pool = drv.pool(torch, sizes, traffic, seed, "cuda")
        got = drv.first_pairs(torch, cfg.program_trainer(torch, sizes, weights, "cuda"), pool)
        want = drv.first_pairs(torch, cfg.reference_trainer(torch, sizes, weights, "cuda"), pool,
                               from_adam=False)
        rows.append(dict(kind="sound", seed=seed, numbers=drv.gaps(got, want),
                         detail=detail(drv, got, want)))
        emit(out, **rows[-1], seconds=time.perf_counter() - t)
        if n < controls:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            low = drv.first_pairs(torch, cfg.reference_trainer(torch, sizes, weights, "cuda"),
                                  pool, from_adam=False)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            rows.append(dict(kind="control_tf32", seed=seed, numbers=drv.gaps(low, want),
                             detail=detail(drv, low, want)))
            emit(out, **rows[-1])
            for kind, (d, g) in HALVED.items():
                state, d_step, g_step = cfg.program_trainer(torch, sizes, weights, "cuda")
                bad = drv.first_pairs(torch, (state, halved(d_step) if d else d_step,
                                              halved(g_step) if g else g_step), pool)
                rows.append(dict(kind=kind, seed=seed, numbers=drv.gaps(bad, want),
                                 detail=detail(drv, bad, want)))
                emit(out, **rows[-1])
        torch.cuda.empty_cache()
    return rows


def detail(drv, got, want):
    """What the look needs beside the numbers: each step's loss gap, the
    worst leaves, and G's first gradient (not compared) read three ways:
    its worst leaf (with that leaf's reference norm against the median
    leaf's), the 90th percentile and the median of its leaves' gaps."""
    from portbench.core import compare

    import numpy as np

    steps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got["losses"], want["losses"])]
    part = {p: {k: v for k, v in want["grad"].items() if k.startswith(p + ".")}
            for p in ("d", "g")}
    g_gaps = compare.leaf_gaps(got["grad"], part["g"])
    g_worst = max(g_gaps, key=lambda k: (g_gaps[k] != g_gaps[k], g_gaps[k]))
    g_median = float(np.median(list(part["g"].values())))
    change = compare.leaf_gap(got["change"], want["change"])
    med = float(np.median([want["change"][k] for k in want["change"]]))
    median_leaf = min(want["change"], key=lambda k: abs(want["change"][k] - med))
    return dict(loss_steps=steps, losses=got["losses"], ref_losses=want["losses"],
                d_grad_worst_leaf=compare.leaf_gap(got["grad"], part["d"])[1],
                g_grad_worst=g_gaps[g_worst], g_grad_worst_leaf=g_worst,
                g_grad_worst_ref_over_median=part["g"][g_worst] / max(g_median, 1e-30),
                g_grad_p90=float(np.percentile(list(g_gaps.values()), 90)),
                g_grad_median=compare.median_leaf_gap(got["grad"], part["g"]),
                change_worst_leaf=change[1],
                median_leaf_change_gap=abs(got["change"][median_leaf] - med) / max(med, 1e-30))


def infer(torch, cell, sizes, cfg, traffic, drv, seeds, controls, out, work):
    """Sound runs (the program's cached request, as the window serves it,
    against the reference), the fp8/TF32 control and an answer altered
    where it is produced (the output frames in reverse order)."""
    import numpy as np

    from portbench.core import compare, synth
    from portbench.reference.io.audio_io import load_wav

    weights = cfg.ensure_weights(torch, sizes, ROOT / "portbench" / ".cache" / "weights", "cuda")
    pipe = cfg.program(torch, sizes, weights, str(work / "tmp"), "cuda")
    ref = cfg.Reference(torch, sizes, weights, "cuda")
    low = None
    rows = []
    s = sizes["frame_size"]
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        gen = synth.generator(torch, synth.stream(seed, 1, 0), "cuda")
        clip_path = str(work / f"clip{n}.npz")
        frames = synth.clip_frames(torch, traffic["clip_frames"], s, s, gen, "cuda")
        np.savez(clip_path, frames=frames, fps=sizes["fps"])
        wavs = []
        for i in (drv.WARMUP, 0):
            p = str(work / f"speech{n}_{i}.wav")
            synth.write_wav(p, synth.speech(torch, traffic["speech_seconds"], synth.generator(
                torch, synth.stream(seed, 2, i), "cuda")))
            wavs.append(p)
        pipe.run(clip_path, wavs[0], str(work / "out.npz"))
        served = np.load(pipe.run(clip_path, wavs[1], str(work / "out.npz")))["frames"]
        rng = np.random.default_rng(synth.stream(seed, 3))
        idx = sorted(rng.choice(len(served), size=traffic["compare_frames"],
                                replace=False).tolist())
        wav = load_wav(wavs[1], sizes["sample_rate"])
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        want = ref.outputs(frames, wav, idx)
        got = served[idx]
        rows.append(dict(kind="sound", seed=seed, numbers=compare.frames(got, want)))
        emit(out, **rows[-1], seconds=time.perf_counter() - t)
        if n < controls:
            if low is None:
                low = cfg.Reference(torch, sizes, weights, "cuda", below=True)
            lowered = low.outputs(frames, wav, idx)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            rows.append(dict(kind="control_fp8_tf32", seed=seed,
                             numbers=compare.frames(lowered, want)))
            emit(out, **rows[-1])
            rows.append(dict(kind="fault_answer_altered", seed=seed,
                             numbers=compare.frames(served[idx[::-1]], want)))
            emit(out, **rows[-1])
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", help="a file to append the readings to as well")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import tempfile

    import torch

    from portbench.core import registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    sizes, cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    drv = registry.driver(traffic["driver"])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        work = stack.enter_context(tempfile.TemporaryDirectory())
        if traffic["driver"] == "gan_pool":
            rows = train(torch, cell, sizes, cfg, traffic, drv, args.seeds, args.controls, out)
        else:
            rows = infer(torch, cell, sizes, cfg, traffic, drv, args.seeds, args.controls, out,
                         Path(work))
        emit(out, kind="summary", cell=cell["name"], card=torch.cuda.get_device_name(0),
             summary=summarise(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
