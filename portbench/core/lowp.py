"""Precision one step below bfloat16, for the controls: fp8 (e4m3) inputs
and weights of every convolution and matrix product that runs under
autocast, each tensor scaled by its own largest magnitude, as an fp8 GEMM
with per-tensor scales takes them; the products then run in bfloat16."""

from __future__ import annotations

import contextlib

E4M3_MAX = 448.0
PRODUCTS = {"conv1d", "conv2d", "conv3d", "conv_transpose2d", "linear", "matmul", "mm", "bmm",
            "addmm", "baddbmm", "einsum"}


def fp8_round(torch, x):
    """x rounded to e4m3 under a per-tensor scale, returned in x's dtype."""
    if not (torch.is_tensor(x) and x.is_floating_point()) or x.numel() == 0:
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _autocast_on(torch, device_type: str = "cuda") -> bool:
    try:
        return torch.is_autocast_enabled(device_type)
    except TypeError:
        return torch.is_autocast_enabled()


@contextlib.contextmanager
def fp8_under_autocast(torch, enabled: bool = True):
    """Inside, a product's first two tensor arguments are rounded to fp8
    whenever autocast is on (the regions a configuration runs in bfloat16)."""
    if not enabled:
        yield
        return
    from torch.overrides import TorchFunctionMode

    class Fp8(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if getattr(func, "__name__", "") in PRODUCTS and _autocast_on(torch):
                args = tuple(fp8_round(torch, a) if i < 2 else a for i, a in enumerate(args))
            return func(*args, **kwargs)

    with Fp8():
        yield
