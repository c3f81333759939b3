"""The port's spans and counters (``s2v_torch/utils/trace.py``) on the CPU:
nesting, parents and request ids (per thread), the ring's bound and drop
count, the counters behind ``launch_counts``, no ``record_function`` without
a profiler and every span an annotation under one, ``write_chrome`` in the
profiler's time base, and the spans of the trainer's steps, the harness's
engines and the training batches. ``LipSyncPipeline.run``'s span tree and
the cache's hits and misses are held in tests/test_torch_run.py."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from s2v_torch.models.gpen import Discriminator, FullGenerator
from s2v_torch.ops.kernels import launch_counts, reset_launch_counts
from s2v_torch.prep import degradations
from s2v_torch.train import gan
from s2v_torch.train.harness import Engine
from s2v_torch.utils import trace
from s2v_torch.utils.diagnostics import ThroughputLogger
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _empty_ring():
    trace.reset()
    with one_torch_thread():
        yield
    trace.reset()


def by_name():
    return {r.name: r for r in trace.records()}


def test_spans_nest_with_parents_and_request_ids():
    @trace.span("inner", "decorated")
    def inner():
        return 7

    with trace.span("outer", "t") as outer:
        with trace.span("a"):
            assert inner() == 7
        with trace.span("b"):
            pass
    with trace.span("second"):
        pass
    recs = by_name()
    assert [r.name for r in trace.records()] == ["inner", "a", "b", "outer", "second"]
    assert outer.record == recs["outer"] and recs["outer"].tag == "t"
    assert recs["inner"].tag == "decorated"
    assert recs["outer"].parent is None and recs["second"].parent is None
    assert recs["a"].parent == recs["b"].parent == recs["outer"].id
    assert recs["inner"].parent == recs["a"].id
    assert len({recs[n].request for n in ("outer", "a", "b", "inner")}) == 1
    assert recs["second"].request != recs["outer"].request
    for child, parent in (("a", "outer"), ("inner", "a"), ("b", "outer")):
        assert recs[parent].start <= recs[child].start <= recs[child].end <= recs[parent].end
    assert recs["a"].end <= recs["b"].start
    assert trace.dropped() == 0


def test_spans_on_another_thread_have_their_own_parents():
    started, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("worker"):
            started.set()
            release.wait(10)

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        assert started.wait(10)
        with trace.span("main.child"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    recs = by_name()
    assert recs["worker"].parent is None and recs["main.child"].parent == recs["main"].id
    assert recs["worker"].request != recs["main"].request
    assert recs["worker"].thread != recs["main"].thread


def test_an_exception_closes_the_span():
    with pytest.raises(ValueError):
        with trace.span("fails"):
            raise ValueError("x")
    with trace.span("after"):
        pass
    recs = by_name()
    assert recs["after"].parent is None and recs["fails"].parent is None


def test_the_ring_keeps_the_newest_and_counts_what_it_drops():
    extra = 5
    for i in range(trace.RING + extra):
        with trace.span("s", str(i)):
            pass
    recs = trace.records()
    assert len(recs) == trace.RING and trace.dropped() == extra
    assert recs[0].tag == str(extra) and recs[-1].tag == str(trace.RING + extra - 1)
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_counters_and_the_launch_counts_read_through_them():
    trace.count("cache.hit")
    trace.count("cache.hit", 2)
    trace.count("kernel.launch.fused_act", 3)
    trace.count("kernel.launch.upfirdn2d")
    assert trace.counter("cache.hit") == 3 and trace.counter("never") == 0
    assert launch_counts() == {"fused_act": 3, "fused_act_bwd": 0, "upfirdn2d": 1}
    reset_launch_counts()
    assert launch_counts() == {"fused_act": 0, "fused_act_bwd": 0, "upfirdn2d": 0}
    assert trace.counters() == {"cache.hit": 3}


def test_counters_from_many_threads_lose_no_update():
    """Each thread counts into its own table; the totals add them up."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("kernel.launch.upfirdn2d")
                                                    for _ in range(20_000)])
                   for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["upfirdn2d"] == 12 * 20_000
    assert trace.counters() == {"kernel.launch.upfirdn2d": 12 * 20_000}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = trace.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(trace, "record_function", counted)
    with trace.span("quiet"):
        with trace.span("quiet.child"):
            torch.ones(4).sum()
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("loud"):
            torch.ones(4).sum()
    assert entered == ["loud"]


def test_spans_are_annotations_and_write_chrome_shares_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("warm-up"):  # a process's first annotation builds the profiler's op
            pass
    trace.reset()
    names = ["net.a", "net.b", "step.c", "net.a"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("infer.run"):
            for name in names:
                with trace.span(name):
                    torch.randn(64, 64) @ torch.randn(64, 64)
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    trace.count("cache.miss", 2)
    trace.write_chrome(str(tmp_path / "spans.json"))
    profile_json = json.loads((tmp_path / "profile.json").read_text())
    spans_json = json.loads((tmp_path / "spans.json").read_text())
    notes = sorted((e["ts"], e["name"]) for e in profile_json["traceEvents"]
                   if e.get("cat") == "user_annotation")
    ours = sorted((e["ts"], e["name"]) for e in spans_json["traceEvents"] if e["ph"] == "X")
    assert [n for _, n in ours] == [n for _, n in notes] == ["infer.run"] + names
    base = profile_json.get("baseTimeNanoseconds", 0)
    for (t_ours, _), (t_note, _) in zip(ours, notes):
        t_ours += (spans_json["baseTimeNanoseconds"] - base) / 1e3
        assert abs(t_ours - t_note) < 200, (t_ours, t_note)
    assert spans_json["counters"] == {"cache.miss": 2} and spans_json["dropped"] == 0
    [counter] = [e for e in spans_json["traceEvents"] if e["ph"] == "C"]
    assert counter["name"] == "cache.miss" and counter["args"] == {"cache.miss": 2}
    run = next(e for e in spans_json["traceEvents"] if e["name"] == "infer.run")
    assert {e["args"]["parent"] for e in spans_json["traceEvents"]
            if e["name"].startswith(("net.", "step."))} == {run["args"]["id"]}


def test_d_step_records_r1_exactly_on_the_r1_steps():
    torch.manual_seed(0)
    g = FullGenerator(size=32, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.125)
    d = Discriminator(size=32, channel_multiplier=1, narrow=0.125)
    state, d_step, g_step = gan.make_gan_trainer(g, d, device="cpu", d_reg_every=2)
    rng = np.random.RandomState(8)
    batch = {k: rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for k in ("lq", "hq")}
    for _ in range(4):
        state, _ = d_step(state, batch)
        state, _ = g_step(state, batch)
    recs = trace.records()
    d_ids = [r.id for r in recs if r.name == "gan.d_step"]
    g_ids = [r.id for r in recs if r.name == "gan.g_step"]
    assert len(d_ids) == len(g_ids) == 4
    assert [r.parent for r in recs if r.name == "gan.r1"] == [d_ids[0], d_ids[2]]
    assert [r.parent for r in recs if r.name == "gan.ema"] == g_ids
    assert all(r.parent is None for r in recs if r.name in ("gan.d_step", "gan.g_step"))


def test_engine_elapsed_is_its_span_and_the_batches_have_theirs(tmp_path):
    def step(state, batch):
        with trace.span("inside"):
            return state + batch, {"loss": torch.tensor(float(batch))}

    engine = Engine(state=0, step_fn=step, name="gpen")
    logger = ThroughputLogger(str(tmp_path / "log.jsonl"), every=2)
    for i in (1, 2):
        engine.step(i)
        logger.step(i, 4, {"loss": float(i)})
    steps = [r for r in trace.records() if r.name == "engine.step"]
    assert [r.tag for r in steps] == ["gpen", "gpen"]
    assert engine.elapsed_s == steps[-1].seconds and engine.state == 3
    assert [r.parent for r in trace.records() if r.name == "inside"] == [s.id for s in steps]
    line = json.loads((tmp_path / "log.jsonl").read_text())
    assert sorted(line) == ["loss", "loss_avg", "samples_per_sec", "step"]
    assert line["step"] == 2 and line["samples_per_sec"] > 0

    imgs = (np.random.RandomState(9).rand(3, 16, 16, 3) * 255).astype(np.uint8)
    trace.reset()
    batches = degradations.face_batches(imgs, 2, rng=np.random.default_rng(0), steps=3,
                                        degrader=degradations.GFPGANDegrader(jpeg_range=None))
    for _ in batches:
        with trace.span("consumer"):
            pass
    made = [r for r in trace.records() if r.name == "data.face_batches"]
    assert len(made) == 3 and all(r.parent is None for r in trace.records())


def test_the_finetune_step_nests_its_spans_and_counts_its_frames():
    """``make_enet_finetune_step`` at batch 16 (a slim ENet and ReconNet,
    the pyramid perceptual term): one ``ft.step`` a step, with ``ft.enet``,
    ``ft.perceptual``, ``ft.identity``, ``ft.backward`` and ``ft.adam``
    inside it in that order, and ``ft.frames`` up by 16 a step."""
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.resnet import ReconNet
    from s2v_torch.train.finetune_enet import make_enet_finetune_step, make_id_embed_fn
    from s2v_torch.utils.config import TrainConfig

    torch.manual_seed(0)
    enet = ENet(num_style_feat=32, lnet_res_blocks=1, channel_multiplier=0.25, narrow=0.125,
                lnet_base_nc=8, lnet_max_nc=16)
    embed = make_id_embed_fn(ReconNet(layers=(1, 1, 1, 1), base_planes=8))
    state, step = make_enet_finetune_step(enet, TrainConfig(), device="cpu", id_embed_fn=embed)
    rng = np.random.RandomState(3)
    batch = {"mel": rng.randn(16, 80, 16, 1).astype(np.float32),
             "face": rng.rand(16, 96, 96, 6).astype(np.float32),
             "ref": rng.rand(16, 96, 96, 3).astype(np.float32),
             "target": rng.rand(16, 384, 384, 3).astype(np.float32)}
    for n in (1, 2):
        state, _ = step(state, batch)
        assert trace.counter("ft.frames") == 16 * n
    recs = trace.records()
    steps = [r for r in recs if r.name == "ft.step"]
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    inner = ["ft.enet", "ft.perceptual", "ft.identity", "ft.backward", "ft.adam"]
    for s in steps:
        kids = sorted((r for r in recs if r.parent == s.id), key=lambda r: r.start)
        assert [r.name for r in kids] == inner
        assert all(s.start <= r.start and r.end <= s.end for r in kids)
