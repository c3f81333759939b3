"""Find a cell's parts by the names in BENCHMARK.json.

A cell ``<config>.<traffic>`` joins three kinds of file, each found by
name, so that a new cell, configuration or per-layer metric is new files
and new entries only:

- ``configs/<config>.json``: the configuration's sizes as run (the file
  BENCHMARK.json names), and ``configs/<config>.py``: the functions that
  build the program's side and the plain reference's side from it;
- ``traffic/<traffic>.json``: the traffic's parameters, with the name of
  the driver that generates it (``drivers/<driver>.py``);
- ``layer_metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_file_module(path: Path, name: str) -> ModuleType:
    """Import a file by path under a private module name (metric files have
    dots in their names, which ``import`` cannot take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"have {[w['name'] for w in bench['workloads']]}")


def workload_files(package: Path = PACKAGE) -> List[str]:
    """Every cell that the files under ``package`` can run: each pair of a
    configuration (``configs/<c>.json`` with its ``.py``) and a traffic
    file whose driver exists, named ``<c>.<traffic>``, where the traffic
    file lists the configuration (``configs``) or lists none."""
    names = []
    for cfg in sorted((package / "configs").glob("*.json")):
        if not cfg.with_suffix(".py").is_file():
            continue
        for tr in sorted((package / "traffic").glob("*.json")):
            spec = json.loads(tr.read_text())
            if not (package / "drivers" / f"{spec['driver']}.py").is_file():
                continue
            if cfg.stem in spec.get("configs", [cfg.stem]):
                names.append(f"{cfg.stem}.{tr.stem}")
    return names


def config(name: str, package: Path = PACKAGE) -> tuple:
    """(the sizes file as a dict, the builder module) of configuration
    ``name``."""
    sizes = json.loads((package / "configs" / f"{name}.json").read_text())
    return sizes, load_file_module(package / "configs" / f"{name}.py", f"_pb_config_{name}")


def traffic(name: str, package: Path = PACKAGE) -> dict:
    return json.loads((package / "traffic" / f"{name}.json").read_text())


def driver(name: str, package: Path = PACKAGE) -> ModuleType:
    return load_file_module(package / "drivers" / f"{name}.py", f"_pb_driver_{name}")


def layer_metrics(bench: dict, cell_name: str, package: Path = PACKAGE) -> Dict[str, ModuleType]:
    """The reader of every per-layer metric whose ``workloads`` list this
    cell (or that lists none), by name."""
    out = {}
    for m in bench["per_layer"]:
        if cell_name in m.get("workloads", [cell_name]):
            out[m["name"]] = load_file_module(package / "layer_metrics" / f"{m['name']}.py",
                                              f"_pb_metric_{m['name'].replace('.', '_')}")
    return out


def limits(cell_name: str, package: Path = PACKAGE) -> Dict[str, float]:
    """The limit of each number that decides ``correct`` in this cell
    (``limits/<cell>.json``: number -> limit, with the readings each was
    set from beside it); empty where there is no file."""
    path = package / "limits" / f"{cell_name}.json"
    if not path.is_file():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}
