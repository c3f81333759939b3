"""The benchmark's ENet fine-tune cell (``enet_finetune.clip_steps``) on the
CPU at the configuration's slim sizes (``configs/enet_finetune.py``
``slim_sizes``, ``SLIM_TRAFFIC``): the port's ``train`` command inputs and
``make_enet_finetune_step`` against the frozen plain reference
(``portbench/reference/train/finetune_enet.py``) from seeded random
weights over the first three steps, through ``run.execute`` as the card
runs it; and the readers of the step's spans on a synthetic profile.

Tolerances of the sound run: the port and the reference compute the same
f32 operations in the same order on one CPU thread, so the first
prediction and the three terms agree exactly (0); the first gradient is
read from Adam's first moment (scaled by 0.1 and back) and the change is
Adam's three updates, so their worst leaf's norm gap is held to 1e-5
(measured 7e-8 and 7e-7), against the limits of 2e-5 the card's runs are
held to. The planted faults are in ``test_portbench_enet_finetune_faults.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import pytest
import torch

from portbench.core import registry
from portbench.core.finetune_trace import device_ms_per_frame, device_split, step_ms
from portbench.core.trace import Profile, Span, Spans, TraceData
from s2v_torch.utils import trace
from torch_parity import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]
CELL = "enet_finetune.clip_steps"
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def limits() -> dict:
    return {k: v["limit"] for k, v in json.loads(
        (ROOT / "portbench" / "limits" / f"{CELL}.json").read_text()).items()}


def run_cell(cache: Path, monkeypatch, trace_on: int = 0) -> dict:
    """One run of the cell on the CPU at slim sizes and with the slim clip;
    the result line's object."""
    from portbench import run as bench_run

    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, CELL)
    _, cfg = registry.config(cell["config"])
    original = registry.traffic

    def slim_traffic(name, package=registry.PACKAGE):
        return {**original(name, package), **cfg.SLIM_TRAFFIC}

    monkeypatch.setattr(registry, "traffic", slim_traffic)
    # this suite's conftest loads JAX for the other files; the run's own
    # check for it (no JAX beside the program) is portbench/tests' to make
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [])
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.2, trace=trace_on)
    return bench_run.execute(args, bench, cell, "cpu", torch, sizes=cfg.slim_sizes(),
                             cache=cache)


def values(out: dict) -> dict:
    return {k: v["value"] for k, v in out["compared"].items()}


def test_the_port_step_agrees_with_the_reference_over_three_steps(tmp_path, monkeypatch):
    out = run_cell(tmp_path, monkeypatch)
    v = values(out)
    assert out["correct"] and out["failed"] == 0
    assert set(v) == {"pred_gap", "loss_gap", "grad_gap", "change_gap", "frozen_changed"}
    assert v["pred_gap"] == 0.0 and v["loss_gap"] == 0.0
    assert v["grad_gap"] <= 1e-5 and v["change_gap"] <= 1e-5
    assert v["frozen_changed"] == 0.0
    assert set(out["metrics"]) == {"train_pairs_per_s", "peak_mem_gib", "setup_s"}
    assert out["metrics"]["train_pairs_per_s"]["value"] > 0


def test_a_traced_run_reports_the_step_span_and_the_whole_step(tmp_path, monkeypatch):
    """A traced slim run on the CPU: the profile holds no device operation,
    so the per-span device times read nothing; the step's span, the idle
    share and the MFU read."""
    out = run_cell(tmp_path, monkeypatch, trace_on=1)
    assert out["correct"]
    assert {"ft_step_ms", "device_idle_pct.finetune", "mfu.finetune"} <= set(out["metrics"])
    assert not any(k.endswith("_device_ms_per_frame") for k in out["metrics"])


def ann(name, a, b):
    return (name, float(a), float(b - a))


def profile() -> Profile:
    """Two frames' step over [0, 1000] us: ENet's two operations and a
    replayed graph's kernel after them (no ``External id``), VGG16's,
    ReconNet's, a backward operation launched on autograd's thread (its
    host operation on another thread, inside ``ft.backward`` by time),
    Adam's, the L1 in the step itself, and one operation whose host
    operation the profile lacks, with a graph kernel after it."""
    notes = [ann("portbench.profiled", 0, 1000), ann("step", 0, 1000), ann("ft.step", 5, 990),
             ann("ft.enet", 10, 300), ann("ft.perceptual", 320, 500),
             ann("ft.identity", 510, 600), ann("ft.backward", 610, 900),
             ann("Optimizer.step#Adam.step", 910, 980), ann("ft.adam", 905, 985)]
    host = [("aten::conv2d", 20, 5, {"External id": 1}), ("aten::mm", 200, 5, {"External id": 2}),
            ("aten::sub", 305, 2, {"External id": 3}),
            ("aten::conv2d", 330, 5, {"External id": 4}),
            ("aten::conv2d", 520, 5, {"External id": 5}),
            ("autograd::engine::evaluate_function: ConvolutionBackward0", 650, 40,
             {"External id": 6}),
            ("aten::_foreach_add_", 920, 5, {"External id": 7})]
    device = [("k1", 30.0, 100.0, 1), ("k2", 210.0, 40.0, 2), ("graph", 255.0, 20.0, None),
              ("k3", 306.0, 4.0, 3), ("k4", 340.0, 100.0, 4), ("k5", 530.0, 50.0, 5),
              ("k6", 660.0, 200.0, 6), ("k7", 930.0, 10.0, 7), ("k8", 990.0, 2.0, 99),
              ("graph", 993.0, 3.0, None)]
    return Profile(0.0, 1000.0, device, host, notes, units=2.0)


def test_device_time_goes_to_the_innermost_fine_tune_span_and_graphs_to_the_op_before():
    prof = profile()
    split = device_split(prof)
    assert split == pytest.approx({"ft.enet": 160e-6, "ft.step": 4e-6, "ft.perceptual": 100e-6,
                                   "ft.identity": 50e-6, "ft.backward": 200e-6,
                                   "ft.adam": 10e-6, None: 5e-6})
    td = TraceData(window_s=1.0, units=4.0, spans=None, profile=prof, twin_s=0.002)
    assert device_ms_per_frame(td, "ft.enet") == pytest.approx(0.08)
    assert device_ms_per_frame(td, "ft.backward") == pytest.approx(0.1)
    assert device_ms_per_frame(td, "net.enet") is None


def test_readers_read_nothing_without_the_spans():
    bare = Profile(0.0, 1000.0, [("k1", 30.0, 100.0, 1)], [("aten::mm", 20, 5,
                                                            {"External id": 1})],
                   [ann("portbench.profiled", 0, 1000), ann("step", 0, 1000)], units=2.0)
    td = TraceData(window_s=1.0, units=4.0, spans=None, profile=bare, twin_s=0.002)
    assert device_split(bare) is None and device_ms_per_frame(td, "ft.enet") is None
    assert device_ms_per_frame(TraceData(1.0, 4.0, None, None), "ft.enet") is None
    assert step_ms(td) is None


def test_step_ms_reads_the_program_spans_inside_the_benchmark_steps():
    trace.reset()
    spans = Spans(torch, "cpu")
    with trace.span("ft.step"):   # set-up's: outside every benchmark step
        pass
    for _ in range(2):
        with spans("step"):
            with trace.span("ft.step"):
                with trace.span("ft.enet"):
                    pass
    spans.records.append(Span("other", 0.0, 0.0, None))
    td = TraceData(window_s=1.0, units=32.0, spans=spans, profile=None)
    inside = [r for r in trace.records() if r.name == "ft.step"][1:]
    assert step_ms(td) == pytest.approx(1e3 * sum(r.seconds for r in inside) / 2)
    trace.reset()
