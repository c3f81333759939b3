"""FLOPs of the plain reference at the shapes the program ran, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device, so that
the count stays what it is whatever a later change does to the program's
implementation; and the least time those FLOPs take at the H100's peak."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from portbench.core.compare import rebuild
from portbench.core.peaks import FLOP_PER_S


def count(torch, fn) -> int:
    """FLOPs of the operators ``fn`` dispatches, by the formulas of
    ``torch.utils.flop_counter`` (those of ``FlopCounterMode``, without its
    module tracking, which R1's double backward does not take)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                Count.total += int(formula(*args, **kwargs, out_val=out))
            return out

    with Count():
        fn()
    return Count.total


def ideal_seconds(torch, nets: Dict[str, "torch.nn.Module"],
                  calls: Iterable[Tuple[str, tuple, bool]]) -> float:
    """Sum over the calls (role, ``spec`` record, autocast on) of the
    reference network's FLOPs at those shapes over the peak of the
    precision the call ran in: bfloat16 under autocast, else float32
    without TF32. Each distinct call is counted once."""
    flops: Dict[tuple, int] = {}
    total = 0.0
    for role, record, amp in calls:
        key = (role, record)
        if key not in flops:
            args, kwargs = rebuild(torch, record)
            with torch.no_grad():
                flops[key] = count(torch, lambda: nets[role](*args, **kwargs))
        total += flops[key] / FLOP_PER_S["bfloat16" if amp else "float32"]
    return total
