"""Shared pieces of the benchmark's CPU tests: slim sizes of both
configurations, a run of a cell on the CPU (the harness's look for a chip
skipped), and the ``card`` fixture of the tests marked ``cuda``."""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))


def slim_sizes(config: str) -> dict:
    sizes = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    if config == "gpen512_train":
        sizes["generator"] = dict(size=64, style_dim=64, n_mlp=2, channel_multiplier=1,
                                  narrow=0.25)
        sizes["discriminator"] = dict(size=64, channel_multiplier=1, narrow=0.25)
        return sizes
    # geometries that the program's loader reads back from the files
    # (FAN's four modules, GPEN at 2048 and GFPGAN at 512 are fixed there)
    n = sizes["networks"]
    n["recon"]["kwargs"] = {"layers": [1, 1, 1, 1], "base_planes": 8}
    n["dnet"]["kwargs"] = {"descriptor_nc": 16, "warp_base_nc": 8, "edit_base_nc": 8,
                           "max_nc": 32}
    n["enet"]["kwargs"] = {"lnet_res_blocks": 2, "channel_multiplier": 0.25, "narrow": 0.25,
                           "lnet_base_nc": 8, "lnet_max_nc": 32}
    n["retinaface"]["kwargs"] = {"out_channel": 64}
    n["parsenet"]["kwargs"] = {"base_ch": 16, "max_ch": 32, "min_ch": 8, "res_depth": 2}
    n["gfpgan"]["kwargs"] = {"out_size": 512, "num_style_feat": 64, "channel_multiplier": 0.5,
                             "narrow": 0.125, "num_mlp": 2}
    n["gpen512"]["kwargs"] = {"size": 512, "narrow": 0.125, "channel_multiplier": 1,
                              "style_dim": 64, "n_mlp": 2}
    n["gpen2048"]["kwargs"] = {"size": 2048, "narrow": 0.25, "channel_multiplier": 1,
                               "style_dim": 64, "n_mlp": 2}
    n["srmodel"]["kwargs"] = {"scale": 2, "num_feat": 16, "num_block": 2, "num_grow_ch": 8}
    sizes["frame_size"] = 96
    sizes["pipeline"]["parse_size"] = 64
    sizes["weight_seed"] = 7
    return sizes


SLIM_TRAFFIC = dict(clip_frames=6, speech_seconds=0.2, compare_frames=2)


def run_on_cpu(cell_name: str, seed: int, cache: Path, trace: int = 0, seconds: float = 0.5,
               monkeypatch=None) -> dict:
    """One run of the cell on the CPU at slim sizes (slim traffic for the
    inference cells); returns the result line's object."""
    import torch

    import run as bench_run
    from portbench.core import registry

    bench = registry.load_benchmark(ROOT)
    cell = registry.cell(bench, cell_name)
    if monkeypatch is not None:
        original = registry.traffic

        def slim_traffic(name, package=registry.PACKAGE):
            t = original(name, package)
            if t["driver"] == "infer_requests":
                t.update(SLIM_TRAFFIC)
            return t

        monkeypatch.setattr(registry, "traffic", slim_traffic)
    args = argparse.Namespace(workload=cell_name, seed=seed, seconds=seconds, trace=trace)
    torch.set_num_threads(4)
    return bench_run.execute(args, bench, cell, "cpu", torch,
                             sizes=copy.deepcopy(slim_sizes(cell["config"])), cache=cache)


@pytest.fixture(scope="session")
def weights_cache(tmp_path_factory) -> Path:
    return tmp_path_factory.mktemp("portbench_cache")


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")
