"""Device selection for the port's entry points, the precision policies of
its networks (``precision``, applied by ``s2v_torch.pipeline.nets``) and
constants kept on a device (``constant_on``)."""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: raises when CUDA is unavailable instead of
    running on the CPU. Pass ``"cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "s2v_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls in full f32 inside, without TF32 (cuDNN
    allows it by default): boxes, landmarks and coefficients as s2v_tpu's."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def timed_convolutions():
    """cuDNN's autotuner (``cudnn.benchmark``) on inside: the first call of
    each convolution shape times cuDNN's candidate algorithms on the card
    and keeps the fastest for the process; later calls of that shape reuse
    it. Precision is the caller's: under ``full_f32`` only true f32
    algorithms are candidates. cuDNN caches one plan per shape whichever
    way it was chosen, so a shape must first run inside this context for
    the timed plan to be the one kept. FAN runs so: cuDNN's heuristics send
    its 3x3 f32 convolutions to FFT algorithms, which on an H100 take 2x
    the time of the implicit GEMMs the autotuner finds at batch 32 and
    16-26x at batches 18 and 15 (``tools/fan_conv_probe.py``). A no-op on
    the CPU."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    cudnn.benchmark = True
    try:
        yield
    finally:
        cudnn.benchmark = saved


@contextlib.contextmanager
def precision(policy: str, device: torch.device, dtype: str):
    """A network's precision policy on ``device`` (``s2v_torch.pipeline.nets``):
    "f32" is full f32; "detector" full f32 with bf16 autocast on any device
    when ``dtype`` (``model.detector_dtype``) is "bfloat16" (the convs cast
    their weights, as s2v_tpu's do, ops/convs.py:154-165; callers decode in
    f32); "generator" bf16 autocast on a card when ``dtype``
    (``model.dtype``) is "bfloat16", the TF32 flags as the caller left them."""
    f32 = contextlib.nullcontext() if policy == "generator" else full_f32()
    cast = contextlib.nullcontext() if policy == "f32" else torch.autocast(
        device.type, dtype=torch.bfloat16,
        enabled=dtype == "bfloat16" and (policy == "detector" or device.type == "cuda"))
    with f32, cast:
        yield


@functools.lru_cache(maxsize=None)
def constant_on(values, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``values`` (a tuple of numbers or of tuples, or a host tensor its
    maker caches, keyed by identity) as a ``dtype`` tensor on ``device``,
    copied once: a copy from pageable memory at every call makes the host
    wait for the card's queue. Shared: callers do not write to it."""
    return torch.as_tensor(values, dtype=dtype, device=device)
