"""The port stands alone: importing every s2v_torch module pulls in neither
jax nor s2v_tpu, and its entry points refuse to run without a card unless
the caller asks for the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import s2v_torch

REPO = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(s2v_torch.__path__, "s2v_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _modules()
    assert "s2v_torch.pipeline.inference" in mods and "s2v_torch.ops.kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 's2v_tpu', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "s2v_tpu", "flax")]


def test_entry_points_raise_without_a_card():
    code = ("import torch\n"
            "assert not torch.cuda.is_available()\n"
            "from s2v_torch.device import resolve_device\n"
            "for dev in (None, 'cuda'):\n"
            "    try:\n"
            "        resolve_device(dev)\n"
            "    except RuntimeError:\n"
            "        continue\n"
            "    raise SystemExit('ran without a card')\n"
            "assert resolve_device('cpu').type == 'cpu'\n")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
