"""Device selection for the port's entry points."""

from __future__ import annotations

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
