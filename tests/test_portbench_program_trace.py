"""The benchmark's readers of the program's own spans
(``portbench/core/program_trace.py`` and the ``layer_metrics`` files that
use it) on a synthetic profile, a synthetic traced window and the
program's ring: each reader's value, the per-network and glue device times
adding up to the device time the program's spans hold, the idle split
within the twin's idle time, and None where there is nothing to read (no
program annotation in the profile, a program without the ring, a ring that
dropped records inside the window)."""

import collections
import sys
from pathlib import Path

import pytest

from portbench.core import program_trace as pt
from portbench.core.registry import load_file_module
from portbench.core.trace import Profile, Span, Spans, TraceData
from s2v_torch.utils import trace

METRICS = Path(__file__).resolve().parents[1] / "portbench" / "layer_metrics"
NETS = ("enet", "gfpgan", "retinaface", "parsenet", "gpen", "sr", "landmarks", "recon_dnet")


def reader(name):
    return load_file_module(METRICS / f"{name}.py", f"_test_metric_{name}")


def ann(name, a, b):
    return (name, float(a), float(b - a))


def profile(program=True):
    """A profiled request of 2 frames over [0, 1000] us: ENet's two
    operations under a Step-6 batch, GPEN's under the final stage, S3FD's
    and FAN's under a sweep, one operation of the glue, one after
    ``infer.run`` and one the profiler linked to no host operation."""
    notes = [ann("portbench.profiled", 0, 1000), ann("request", 0, 1000),
             ann("synthesize", 5, 995)]
    if program:
        notes += [ann("infer.run", 10, 990), ann("step6.lipsync", 90, 210),
                  ann("net.enet", 100, 200), ann("step6.final_stage", 290, 600),
                  ann("net.gpen", 300, 500), ann("step1.landmarks", 600, 690),
                  ann("net.s3fd", 610, 640), ann("net.fan", 640, 680)]
    host = [("aten::conv2d", 110, 5, {"External id": 1}), ("cudaLaunchKernel", 111, 1,
                                                             {"External id": 1}),
            ("aten::conv2d", 150, 5, {"External id": 2}), ("aten::add", 250, 2,
                                                           {"External id": 3}),
            ("aten::mm", 310, 5, {"External id": 4}), ("aten::copy_", 995, 1,
                                                       {"External id": 5}),
            ("aten::conv2d", 620, 2, {"External id": 7}), ("aten::conv2d", 650, 2,
                                                           {"External id": 8})]
    device = [("k1", 120.0, 50.0, 1), ("k2", 180.0, 30.0, 2), ("k3", 260.0, 20.0, 3),
              ("k4", 320.0, 100.0, 4), ("k5", 996.0, 2.0, 5), ("k6", 700.0, 10.0, None),
              ("k7", 640.0, 15.0, 7), ("k8", 660.0, 25.0, 8)]
    return Profile(0.0, 1000.0, device, host, notes, units=2.0)


def traced(prof, twin_s=0.002):
    return TraceData(window_s=1.0, units=4.0, spans=None, profile=prof, twin_s=twin_s)


def test_each_network_reader_sums_its_spans_device_time():
    td = traced(profile())
    got = {n: reader(f"{n}_device_ms_per_frame").read(td) for n in NETS + ("glue",)}
    # us over 2 frames, in ms
    assert got == pytest.approx(dict(enet=0.040, gfpgan=None, retinaface=None, parsenet=None,
                                     gpen=0.050, sr=None, landmarks=0.020, recon_dnet=None,
                                     glue=0.010))
    split = pt.device_split(td.profile)
    held = sum(v for k, v in split.items() if k is not None)
    assert sum(v for v in got.values() if v) == pytest.approx(1e3 * held / 2)
    assert split[None] == pytest.approx(12e-6)  # after infer.run, and the unlinked one


def test_the_idle_split_within_the_twins_idle_time():
    td = traced(profile())
    split = pt.idle_split(td.profile)
    # gaps by midpoint: [170,180] in net.enet, [280,320] in net.gpen (which
    # starts at 300), [655,660] in net.fan; [0,120], [210,260], [420,640],
    # [685,700] and [710,996] inside infer.run and outside every network;
    # [998,1000] after infer.run
    assert split == pytest.approx(dict(networks=55e-6, glue=691e-6, other=2e-6), abs=1e-12)
    busy = td.profile.busy_s()
    twin_idle_ms = 1e3 * (td.twin_s - busy) / 2
    nets = reader("idle_in_networks_ms_per_frame").read(td)
    glue = reader("idle_in_glue_ms_per_frame").read(td)
    total = sum(split.values())
    assert nets == pytest.approx(twin_idle_ms * split["networks"] / total)
    assert glue == pytest.approx(twin_idle_ms * split["glue"] / total)
    assert nets + glue <= twin_idle_ms


@pytest.mark.parametrize("name", [f"{n}_device_ms_per_frame" for n in NETS + ("glue",)]
                         + ["idle_in_networks_ms_per_frame", "idle_in_glue_ms_per_frame"])
def test_nothing_to_read_without_program_annotations(name):
    assert reader(name).read(traced(profile(program=False))) is None
    assert reader(name).read(traced(None)) is None


def test_innermost_labels_nested_intervals_and_their_edges():
    inner = pt.Innermost([(0.0, 10.0, "a"), (2.0, 5.0, "b"), (5.0, 7.0, "c"), (2.0, 3.0, "d")])
    assert [inner.at(t) for t in (-1, 0, 1.9, 2, 2.5, 3, 4.9, 5, 6.9, 7, 10)] == [
        None, "a", "a", "d", "d", "b", "b", "c", "c", "a", None]


@pytest.fixture
def clock(monkeypatch):
    """The ring's clock stepped by hand: ``clock(t)`` sets its next reading."""
    now = [0.0]
    monkeypatch.setattr(trace, "_clock", lambda: now[0])
    trace.reset()
    yield lambda t: now.__setitem__(0, float(t))
    trace.reset()


def spanned(clock, name, a, b, tag=None):
    clock(a)
    s = trace.span(name, tag)
    s.__enter__()
    clock(b)
    s.__exit__(None, None, None)


def window(requests):
    spans = Spans(None)
    spans.records = [Span("request", a, b, None) for a, b in requests]
    return TraceData(window_s=30.0, units=4.0, spans=spans, profile=None)


def fill(clock):
    """Set-up's load_models, a window request at [10, 20] and the profiled
    request at [30, 40], which the benchmark's spans leave out."""
    spanned(clock, "setup.load_models", 1, 3)
    spanned(clock, "cache.hit", 11, 12, "landmarks")
    spanned(clock, "cache.hit", 12, 13, "ffhq")
    spanned(clock, "cache.miss", 13, 14, "coeffs")
    spanned(clock, "io.write", 15, 16)
    spanned(clock, "io.mux", 16, 16.5)
    spanned(clock, "cache.miss", 31, 32, "landmarks")
    spanned(clock, "io.write", 33, 34)


def test_the_ring_readers_read_the_window(clock):
    fill(clock)
    td = window([(10, 20)])
    assert reader("cache_hit_pct").read(td) == pytest.approx(100 * 2 / 3)
    assert reader("output_write_ms_per_frame").read(td) == pytest.approx(1.5e3 / 4)
    assert reader("load_models_s").read(td) == pytest.approx(2.0)
    assert reader("cache_hit_pct").read(window([(40.5, 41)])) is None
    assert reader("output_write_ms_per_frame").read(window([])) is None


def test_the_ring_readers_read_nothing_where_the_ring_dropped_the_window(clock, monkeypatch):
    monkeypatch.setattr(trace, "RING", 6)
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=6))
    fill(clock)  # 8 records: set-up's load_models and one window lookup dropped
    td = window([(10, 20)])
    assert trace.dropped() == 2 and reader("load_models_s").read(td) is None
    assert reader("cache_hit_pct").read(td) is None
    assert reader("output_write_ms_per_frame").read(td) is None
    # drops that all ended before the window leave it whole
    trace.reset()
    for t in range(6):
        spanned(clock, "step1.landmarks", 0.1 * t, 0.1 * t + 0.05)
    spanned(clock, "cache.hit", 11, 12, "ffhq")
    spanned(clock, "cache.miss", 12, 13, "coeffs")
    assert trace.dropped() == 2
    assert reader("cache_hit_pct").read(td) == pytest.approx(50.0)


def test_the_ring_readers_read_nothing_without_the_programs_ring(clock, monkeypatch):
    fill(clock)
    import s2v_torch.utils

    monkeypatch.delattr(s2v_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "s2v_torch.utils.trace", None)
    td = window([(10, 20)])
    for name in ("cache_hit_pct", "output_write_ms_per_frame", "load_models_s"):
        assert reader(name).read(td) is None


def nested(clock, outer, inner, a, b, tag=None):
    """Span ``outer`` over [a, b] with span ``inner`` (tag ``tag``) inside."""
    clock(a)
    s = trace.span(outer)
    s.__enter__()
    spanned(clock, inner, a + 0.1, b - 0.1, tag)
    clock(b)
    s.__exit__(None, None, None)


def test_graph_replay_pct_reads_the_window_share_of_network_calls_replayed(clock, monkeypatch):
    """Three network calls in the window request at [10, 20], two of them
    holding a replay; a capture, and a replay in the profiled request at
    [30, 40], count for nothing."""
    nested(clock, "net.sr", "graph.capture", 1, 2, "net.sr")
    nested(clock, "net.sr", "graph.replay", 11, 12, "net.sr")
    nested(clock, "net.gpen", "io.write", 12, 13)
    nested(clock, "net.retinaface", "graph.replay", 13, 14, "net.retinaface")
    spanned(clock, "step6.final_stage", 14, 15)
    spanned(clock, "net.parsenet", 31, 32)
    nested(clock, "net.sr", "graph.replay", 33, 34, "net.sr")
    td = window([(10, 20)])
    assert reader("graph_replay_pct").read(td) == pytest.approx(100 * 2 / 3)
    assert reader("graph_replay_pct").read(window([(30, 40)])) == pytest.approx(50.0)
    assert reader("graph_replay_pct").read(window([(40.5, 41)])) is None
    # a program without graph replay (no s2v_torch.utils.graphs) reads nothing
    monkeypatch.setitem(sys.modules, "s2v_torch.utils.graphs", None)
    assert reader("graph_replay_pct").read(td) is None
