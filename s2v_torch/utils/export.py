"""Model export (reference: arcface_torch/torch2onnx.py + onnx_helper.py,
ONNX export for deployment parity checks; s2v_tpu/utils/export.py, which
serialises a jitted function to StableHLO).

The port's counterpart is ``torch.export``: the module's forward traced at
the example shapes into an ``ExportedProgram`` and saved as bytes. The hand
kernels are the ``s2v`` operators (``s2v_torch.ops.kernels``), so the
program keeps them as nodes, and a program loaded on the card launches K1,
K2 and K3 as the eager module does. Includes a parity check mirroring
onnx_helper's output comparison.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.nn as nn

from s2v_torch.device import resolve_device


class _Fn(nn.Module):
    """A function as a module, so that ``torch.export`` can take it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, example_args: Sequence[Any]) -> bytes:
    """``torch.export`` of a module (or of a function, wrapped in one) at
    the example arguments' shapes, under ``no_grad``, saved to bytes."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(blob: bytes) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of ``export_program``'s bytes."""
    import s2v_torch.ops.kernels  # noqa: F401  (defines the s2v operators)

    return torch.export.load(io.BytesIO(blob))


def load_exported(blob: bytes, device=None) -> Callable:
    """A callable that runs the exported program on ``device``: the card
    unless the caller passes ``"cpu"`` (it raises without a card). Its
    arguments are moved there; it runs under ``no_grad``."""
    dev = resolve_device(device)
    module = load_program(blob).module().to(dev)

    def run(*args):
        with torch.no_grad():
            return module(*[a.to(dev) if torch.is_tensor(a) else a for a in args])

    return run


def s2v_nodes(program: torch.export.ExportedProgram) -> dict:
    """Operator name -> count of the ``s2v`` operator nodes in the program's
    graph (``fused_act_fwd``: K1, ``fused_act_bwd``: K2, ``upfirdn2d``: K3)."""
    counts: dict = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("s2v."):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _leaves(out) -> list:
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _leaves(o)]


def save(path: str, fn: Callable, example_args: Sequence[Any]) -> str:
    blob = export_program(fn, example_args)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def check_parity(fn: Callable, blob: bytes, example_args: Sequence[Any],
                 atol: float = 1e-5, device=None) -> Tuple[bool, float]:
    """onnx_helper-style export-vs-eager output comparison: the largest
    absolute difference over every output, and whether it is within
    ``atol``. Both run on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    args = [a.to(dev) if torch.is_tensor(a) else a for a in example_args]
    with torch.no_grad():
        want = fn(*args)
    got = load_exported(blob, dev)(*args)
    want, got = _leaves(want), _leaves(got)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    return err <= atol, err
