"""BENCHMARK.json against the contract it is written to, the files each
name in it leads to, and the imports of everything the benchmark runs."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(b["workloads"]) <= 24 and 1 <= len(b["configs"]) <= 24
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)


def test_names_units_and_text():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, [w["name"] for w in b["workloads"]], [c["name"] for c in b["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_end_to_end_metrics_and_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def reports(b: dict, metric: str, cell: str) -> bool:
    m = next(m for m in b["end_to_end"] if m["name"] == metric)
    return cell in m.get("workloads", [cell])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells and reports(b, m["moves"], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        got = [m["name"] for m in b["end_to_end"] if reports(b, m["name"], w["name"])]
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])


def test_layers_are_named_alike():
    layers = {}
    for m in bench()["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_name_leads_to_its_files():
    """Configurations, traffic, drivers, readers and limits exist, and each
    reader declares what BENCHMARK.json says of it."""
    from portbench.core import registry

    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        sizes = json.loads((ROOT / c["file"]).read_text())
        assert sizes["reduced"] == c["reduced"] and sizes["source"] == c["source"]
        assert (PACKAGE / "configs" / f"{c['name']}.py").is_file()
    for w in b["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        spec = registry.traffic(w["traffic"])
        assert (PACKAGE / "drivers" / f"{spec['driver']}.py").is_file()
        assert registry.limits(w["name"]), f"no limits for {w['name']}"
    for m in b["per_layer"]:
        reader = registry.load_file_module(PACKAGE / "layer_metrics" / f"{m['name']}.py", "r")
        assert (reader.UNIT, reader.SOURCE, reader.LAYER, reader.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"]), m["name"]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_traffic_file_adds_a_cell_with_no_other_file_edited(tmp_path):
    from portbench.core import registry

    copy = tmp_path / "portbench"
    shutil.copytree(PACKAGE, copy, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = digest(copy)
    assert "vrt_default.long_speech" not in registry.workload_files(copy)
    spec = json.loads((copy / "traffic" / "dub.json").read_text())
    spec["speech_seconds"] = 4.0
    (copy / "traffic" / "long_speech.json").write_text(json.dumps(spec))
    after = digest(copy)
    assert set(after) - set(before) == {"traffic/long_speech.json"}
    assert all(after[k] == v for k, v in before.items())
    assert "vrt_default.long_speech" in registry.workload_files(copy)
    assert registry.traffic("long_speech", copy)["speech_seconds"] == 4.0


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("part", ["", "reference"])
def test_imports(part):
    """Nothing under portbench/ imports JAX, Flax or the JAX package (top-level
    names compared whole: s2v_torch is not s2v_tpu); nothing under
    portbench/reference/ imports the port."""
    banned = {"jax", "jaxlib", "flax", "s2v_tpu"} | ({"s2v_torch"} if part else set())
    files = sorted((PACKAGE / part).rglob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f) & banned, f
