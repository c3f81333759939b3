"""Multi-process work sharding (reference: the torch.multiprocessing.Pool
that shards videos across GPUs via CUDA_VISIBLE_DEVICES,
face3d/extract_kp_videos.py:85-109, and emb's rank/env bootstrap,
emb/utils/distributed.py:7-93; s2v_tpu/parallel/hosts.py), keyed off
``torch.distributed``'s rank and world size.

One process per card: ``initialize`` starts the process group (torchrun's
environment, or the arguments given), work lists are sharded by
``process_index``, and side effects that must happen once run under
``leader_only``.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 1800.0) -> None:
    """``dist.init_process_group`` (arcface train.py:23-30), a no-op in a
    single-process run. Without arguments it reads torchrun's ``WORLD_SIZE``
    and ``RANK`` (``init_method`` env://, which also reads ``MASTER_ADDR``
    and ``MASTER_PORT``); ``init_method`` may be ``tcp://localhost:PORT`` or
    ``file://PATH``. ``backend`` defaults to NCCL when a card is present
    (each process then takes the card of ``LOCAL_RANK``), gloo otherwise."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_leader() -> bool:
    """emb utils/distributed.py leader decorators."""
    return process_index() == 0


def shard_work(items: Sequence[T], index: Optional[int] = None,
               count: Optional[int] = None) -> List[T]:
    """This process's slice of a work list, round-robin (the reference's pool
    chunking gives balanced shards)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    return [it for i, it in enumerate(items) if i % count == index]


def leader_only(fn: Callable) -> Callable:
    """Run ``fn`` only on the leader (emb utils/distributed.py
    local_leader_only); other processes get None."""
    def wrapped(*args, **kwargs):
        if is_leader():
            return fn(*args, **kwargs)
        return None

    return wrapped
