"""Device selection for the port's entry points, and the f32 policy of its
detection and regression nets."""

from __future__ import annotations

import contextlib
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
    allows TF32 by default). S3FD, FAN and ReconNet run so: their boxes,
    landmarks and coefficients keep f32 precision, as in s2v_tpu."""
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


def bf16_autocast(device: torch.device, dtype: str):
    """bf16 autocast on ``device`` when ``dtype`` is "bfloat16" (the
    detectors' and ParseNet's ``model.detector_dtype``): their convs run in
    bf16 with the weights cast to it, as s2v_tpu casts its input and its
    convs the weights (ops/convs.py:154-165), on the card and on the CPU
    alike; a no-op for "float32". Callers cast the outputs to f32 before
    any decode."""
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=dtype == "bfloat16")
