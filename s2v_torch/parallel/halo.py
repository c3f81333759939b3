"""Temporal windows over a frame-sharded clip (s2v_tpu/parallel/halo.py).

The pipeline has two temporal stencils that cross shard boundaries when the
frame axis is split over ranks:

- the 26-frame 3DMM coefficient windows fed to DNet's MappingNet
  (futils/inference_utils.py:73-91, edge-clamped): ``gather_windows`` on
  one device, ``sharded_coeff_windows`` over a data group;
- the 5-frame face-box smoothing (futils/inference_utils.py:101-108):
  ``smooth_boxes``, on the host over the whole clip.

The single-process ``infer`` mesh (``s2v_torch.parallel.mesh.FrameMesh``)
computes both on the first device over the whole clip before it splits a
stage's frames, as XLA's global view gives them in JAX. Over a process
group, ``halo_exchange`` sends each rank's boundary rows to its neighbours
(``dist.batch_isend_irecv``), so windows near a shard's edge see their true
neighbours; the clip's two ends are edge-clamped as the reference's
``obtain_seq_index`` clips indices to [0, N - 1].
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist


def window_offsets(window: int) -> np.ndarray:
    """Frame offsets of a temporal window: obtain_seq_index
    (inference_utils.py:73-76) is ``range(i - 13, i + 13)``, offsets
    ``arange(window) - window // 2`` (asymmetric for even windows)."""
    return np.arange(window) - window // 2


def gather_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[N, ...] -> [N, window, ...], indices clamped to [0, N - 1] as
    obtain_seq_index clips them."""
    n = x.shape[0]
    idx = np.clip(np.arange(n)[:, None] + window_offsets(window)[None], 0, n - 1)
    return x[torch.as_tensor(idx, device=x.device)]


def smooth_boxes(boxes: np.ndarray, window: int = 5) -> np.ndarray:
    """get_smoothened_boxes (inference_utils.py:101-108): forward-looking
    ``window``-frame mean, recentred on the last frames near the tail,
    assigned in place into an int array (later windows read smoothed rows;
    values truncate)."""
    cur = np.array(boxes, np.int64)
    n = len(cur)
    for i in range(n):
        win = cur[n - window:] if i + window > n else cur[i:i + window]
        cur[i] = np.trunc(win.mean(axis=0))
    return cur


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """[n_local, ...] -> [n_local + 2 * halo, ...]: this rank's frames with
    ``halo`` rows of each neighbour's on either side, or copies of its own
    first or last row at the clip's ends. Every rank of ``group`` calls it
    with the same ``n_local >= halo``."""
    if x.shape[0] < halo:
        raise ValueError(f"halo {halo} exceeds the {x.shape[0]} frames of a shard")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    x = x.contiguous()
    left = x[:1].expand(halo, *x.shape[1:]).clone()
    right = x[-1:].expand(halo, *x.shape[1:]).clone()
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1) if group is not None else rank - 1
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1) if group is not None else rank + 1
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left, x, right])


def windowed_map(fn: Callable, x: torch.Tensor, window: int, group=None) -> torch.Tensor:
    """``fn(block)`` on this rank's shard ``x`` [n_local, ...] of a clip
    split in order over ``group``, where block [n_local + window - 1, ...]
    holds the shard with ``window // 2`` halo rows on each side (``fn``
    extracts its windows and returns [n_local, ...]). ``window`` is odd."""
    if window % 2 != 1:
        raise ValueError(f"windowed_map takes an odd window, got {window}")
    return fn(halo_exchange(x, window // 2, group))


def sharded_coeff_windows(coeffs: torch.Tensor, window: int, group=None) -> torch.Tensor:
    """This rank's shard [n_local, C] of a clip's coefficients, split in
    order over ``group`` -> its windows [n_local, window, C], equal to those
    rows of ``gather_windows`` of the whole clip. A window that fits in the
    neighbours' shards takes a halo exchange; a wider one (the 26-frame
    window over small shards) all-gathers the clip's coefficients, a few
    hundred bytes a frame, as s2v_tpu does."""
    n_local = coeffs.shape[0]
    offsets = torch.as_tensor(window_offsets(window), device=coeffs.device)
    halo = int(max(-offsets.min(), offsets.max()))
    world = dist.get_world_size(group)
    if world == 1:
        return gather_windows(coeffs, window)
    if halo <= n_local:
        rows = torch.arange(n_local, device=coeffs.device)[:, None] + halo + offsets[None]
        return halo_exchange(coeffs, halo, group)[rows]
    parts = [torch.empty_like(coeffs) for _ in range(world)]
    dist.all_gather(parts, coeffs.contiguous(), group=group)
    full = torch.cat(parts)
    start = dist.get_rank(group) * n_local
    rows = start + torch.arange(n_local, device=coeffs.device)[:, None] + offsets[None]
    return full[rows.clamp(0, full.shape[0] - 1)]
