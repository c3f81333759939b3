"""The H100's published peaks and the least time each hand-written kernel
could take (PERF.md section 6's arithmetic, kept here so that it stays fixed
while the program changes).

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit. A kernel's
bound is the larger of its bytes (each input read once, each output written
once) over HBM's rate and its operations over the f32 rate of the CUDA cores
(67 TFLOP/s), which the elementwise and FIR kernels run on in both dtypes.
"""

from __future__ import annotations

import ast
import math
from typing import Optional, Sequence

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"bfloat16": 989e12, "float16": 989e12, "fp8": 1979e12, "tf32": 495e12,
              "float32": 67e12}
ELEMENTWISE_FLOP_PER_S = FLOP_PER_S["float32"]
DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}

K1, K2, K3 = "s2v::fused_act_fwd", "s2v::fused_act_bwd", "s2v::upfirdn2d"


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / ELEMENTWISE_FLOP_PER_S)


def k1_bound_s(shape: Sequence[int], esize: int) -> float:
    """K1: reads x and the f32 bias, writes out; add, compare, select, scale."""
    n = math.prod(shape)
    return bound_s(2 * n * esize + 4 * shape[1], 4 * n)


def k2_bound_s(shape: Sequence[int], esize: int, with_b: bool) -> float:
    """K2: reads g and out (and b), writes dx; add, compare, multiply."""
    n = math.prod(shape)
    return bound_s(3 * n * esize + (4 * shape[1] if with_b else 0), (3 if with_b else 2) * n)


def upfirdn_out(size: int, k: int, up: int, down: int, p0: int, p1: int) -> int:
    return (size * up + p0 + p1 - k) // down + 1


def k3_bound_s(shape: Sequence[int], esize: int, kh: int, kw: int, up: int, down: int,
               pads: Sequence[int]) -> float:
    """K3: reads x, writes out; 2 operations per tap that meets a nonzero
    sample of the upsampled input."""
    b, c, h, w = shape
    py0, py1, px0, px1 = pads
    out = b * c * upfirdn_out(h, kh, up, down, py0, py1) * upfirdn_out(w, kw, up, down, px0, px1)
    return bound_s((math.prod(shape) + out) * esize, 2 * kh * kw / (up * up) * out)


def _ints(values) -> Optional[list]:
    try:
        return [int(ast.literal_eval(v)) for v in values]
    except (ValueError, SyntaxError, TypeError):
        return None


def op_bound_s(name: str, args: dict) -> Optional[float]:
    """The bound of one K1/K2/K3 operator call from the shapes, types and
    scalars that the profiler recorded (``record_shapes``); None where they
    are not all there."""
    dims, types = args.get("Input Dims"), args.get("Input type")
    if not dims or not types or not dims[0] or types[0] not in DTYPE_BYTES:
        return None
    shape, esize = dims[0], DTYPE_BYTES[types[0]]
    if name == K1:
        return k1_bound_s(shape, esize)
    if name == K2:
        return k2_bound_s(shape, esize, with_b=len(dims) > 2 and bool(dims[2]))
    if name == K3:
        scalars = _ints((args.get("Concrete Inputs") or [])[-8:])
        if scalars is None or len(scalars) != 8 or len(shape) != 4:
            return None
        kh, kw, up, down, *pads = scalars
        return k3_bound_s(shape, esize, kh, kw, up, down, pads)
    return None
