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
