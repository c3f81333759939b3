"""Build and load the port's hand-written CUDA kernels.

Each ``s2v_torch/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use, into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``); a library's file name carries a hash of its
source and flags, so an edited source rebuilds and an unchanged one loads.
Nothing here runs at import time: this module imports on machines without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from s2v_torch.utils import trace

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start one nvcc for ``name``; returns (process, temporary output,
    library path, log file) or None when the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    log = open(so.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, so, log


def _finish(name: str, job) -> None:
    proc, tmp, so, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n"
                           + so.with_suffix(".log").read_text())
    os.replace(tmp, so)


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc each, all
    started together, inside span ``kernel.build`` (tagged with the names
    compiled); counter ``kernel.build`` counts the nvcc runs."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    with trace.span("kernel.build", ",".join(todo)):
        jobs = [(n, _start(n)) for n in todo]
        for n, job in jobs:
            if job is not None:
                _finish(n, job)
                trace.count("kernel.build")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
