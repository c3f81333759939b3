"""Optimizer-state sharding, ZeRO stage 1 over a data group (reference:
third_part/emb/utils/engines.py:19 wraps DeepSpeedEngine, ds config
emb/config.py:62-82; s2v_tpu/parallel/zero.py).

Each rank of the data group keeps the momentum or Adam moments of its share
of the parameters (``torch.distributed.optim.ZeroRedundancyOptimizer``
partitions them greedily by size), steps that share, and broadcasts the
updated parameters, so every rank ends the step with the same replicated
parameters. Gradients must already be reduced over the group
(``s2v_torch.parallel.mesh.allreduce_grads``) when ``step`` runs.

The JAX package annotates optimizer-state leaves above ``min_size`` with a
data-axis sharding and pins the PartialFC classifier's momentum to the model
axis with ``like=``. Here the classifier shard's optimizer stays a plain
per-rank one (its state is the model-axis shard's already), and what the
rule must give is held instead: training identical to replicated state.
"""

from __future__ import annotations

from typing import Iterable, Type

import torch


def shard_opt_state(params: Iterable[torch.nn.Parameter], group,
                    optimizer_class: Type[torch.optim.Optimizer] = torch.optim.SGD,
                    **defaults) -> torch.optim.Optimizer:
    """``optimizer_class(params, **defaults)`` with its state sharded over
    ``group`` (ZeRO-1); the plain optimizer without a group."""
    params = [p for p in params if p.requires_grad]
    if group is None:
        return optimizer_class(params, **defaults)
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=optimizer_class,
                                   process_group=group, **defaults)


def state_numel(optimizer: torch.optim.Optimizer) -> int:
    """Elements of tensor state this rank holds (momentum buffers, moments)."""
    inner = getattr(optimizer, "optim", optimizer)
    return sum(v.numel() for st in inner.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0)
