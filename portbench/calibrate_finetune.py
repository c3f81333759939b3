#!/usr/bin/env python3
"""The readings that the ``enet_finetune`` cells' limits are set from, on
the card: for each seed a sound run of the cell through ``run.execute``
(set-up, a short window and the check, as the benchmark runs it), and over
the first ``--controls`` seeds the same run with each of these planted in
the program (``planted``):

- ``control_tf32``: the program's step in TF32 (its ``full_f32`` turned
  into a context that allows TF32), one precision below the configuration's;
- ``fault_no_perceptual``: the perceptual term reported but left out of
  the loss (``perceptual_weight`` 0);
- ``fault_no_identity``: the identity term alike (``id_weight`` 0);
- ``fault_half_batch``: each step on the first half of its batch (rounded
  up);
- ``fault_frozen_trained``: one frozen leaf (``to_rgbs.1``'s modulated
  conv's weight) trained beside the style convs.

    python3 portbench/calibrate_finetune.py --workload enet_finetune.clip_steps \\
        --seeds 1 2 ... [--controls 2] [--seconds 1] [--out FILE]

Prints one JSON object per run (its compared numbers and ``correct``), and
the summary last: the largest and smallest reading of every number
compared, by kind. The benchmark's own runs do not run this; the CPU tests
plant the faults through ``planted`` too.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FROZEN_LEAF = "to_rgbs.1.modulated_conv.weight"
FAULTS = ("fault_no_perceptual", "fault_no_identity", "fault_half_batch", "fault_frozen_trained")
KINDS = ("control_tf32",) + FAULTS


@contextlib.contextmanager
def _replaced(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _tf32():
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def planted(kind: str):
    """A context inside which the program's fine-tune step
    (``s2v_torch.train.finetune_enet``) carries ``kind`` (``KINDS``;
    "sound" plants nothing)."""
    from s2v_torch.train import finetune_enet as ft

    make, mask = ft.make_enet_finetune_step, ft.style_conv_mask
    if kind == "sound":
        return contextlib.nullcontext()
    if kind == "control_tf32":
        return _replaced(ft, "full_f32", _tf32)
    if kind in ("fault_no_perceptual", "fault_no_identity"):
        weight = "perceptual_weight" if kind == "fault_no_perceptual" else "id_weight"

        def without(enet, cfg, *a, **k):
            return make(enet, dataclasses.replace(cfg, **{weight: 0.0}), *a, **k)

        return _replaced(ft, "make_enet_finetune_step", without)
    if kind == "fault_half_batch":
        def halved(*a, **k):
            state, step = make(*a, **k)
            return state, lambda s, b: step(s, {key: v[: (len(v) + 1) // 2]
                                                for key, v in b.items()})

        return _replaced(ft, "make_enet_finetune_step", halved)
    if kind == "fault_frozen_trained":
        return _replaced(ft, "style_conv_mask",
                         lambda m: {k: v or k == FROZEN_LEAF for k, v in mask(m).items()})
    raise ValueError(f"no such kind: {kind}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="enet_finetune.clip_steps")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=2)
    p.add_argument("--seconds", type=float, default=1.0, help="each run's window")
    p.add_argument("--out", help="a file to append the readings to as well")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run
    from portbench.calibrate import emit, summarise
    from portbench.core import registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    rows = []
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for n, seed in enumerate(args.seeds):
            for kind in ("sound",) + (KINDS if n < args.controls else ()):
                t = time.perf_counter()
                with planted(kind):
                    got = run.execute(argparse.Namespace(workload=cell["name"], seed=seed,
                                                         seconds=args.seconds, trace=0),
                                      bench, cell, "cuda", torch)
                rows.append(dict(kind=kind, seed=seed, correct=got["correct"],
                                 numbers={k: c["value"] for k, c in got["compared"].items()}))
                emit(out, **rows[-1], seconds=time.perf_counter() - t)
                torch.cuda.empty_cache()
        wrong = sorted({r["kind"] for r in rows if r["correct"] != (r["kind"] == "sound")})
        emit(out, kind="summary", cell=cell["name"], card=torch.cuda.get_device_name(0),
             summary=summarise(rows), wrongly_judged=wrong)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
