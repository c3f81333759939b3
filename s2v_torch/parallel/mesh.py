"""Device meshes, frame sharding and data-parallel gradients (reference:
NCCL through torch.distributed, arcface_torch/train.py:58-59 and
GPEN/train_simple.py:384-398; s2v_tpu/parallel/mesh.py).

The JAX package has one ``Mesh`` for both of its uses. PyTorch's idiom
splits it in two:

- **One process, for ``infer``.** ``make_mesh`` builds a ``FrameMesh``: a
  ``data x model`` grid of local devices, every card of
  ``torch.cuda.device_count()`` by default or the list the caller gives
  (``["cpu"] * n`` in the tests). ``map_frames`` splits the leading (frame)
  axis of a chunk over the data axis, runs each slice on a replica of the
  module on that slice's device (``FrameMesh.replica``) and gathers the
  results on the first device. A chunk whose frame count does not divide the
  data axis runs whole on the first device (``shard_frames_if_divisible``).
  Frames are replicated over the model axis, as a ``P("data")`` sharding
  leaves them in JAX, so only the first device of each data row computes.
- **One process per card, for the trainers.** ``make_process_mesh`` returns a
  ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
  ("data", "model") over an initialised process group. The trainers take
  its groups (``data_group``, ``model_group``): each rank feeds its shard of
  the batch, and ``allreduce_grads`` sums or averages the flattened
  gradients over a group after each backward, as NVIDIA's
  stylegan2-ada-pytorch does instead of ``DistributedDataParallel`` (whose
  reducer does not promise the double backward of R1).

Collectives whose gradient the step needs go through
``torch.distributed.nn.functional``: every rank's copy of a collective's
output then counts once in the backward, so a loss that each rank holds
whole is differentiated as ``loss / world`` and its gradients summed
(``s2v_torch.train.arcface``), and a loss of a rank's own shard as it is and
its gradients averaged (the GAN and fine-tune trainers).
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _device(d) -> torch.device:
    """A ``torch.device`` with an index for CUDA (tensors report one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    t = next(itertools.chain(module.parameters(), module.buffers()), None)
    return None if t is None else t.device


class FrameMesh:
    """A ``data x model`` grid of local devices (``devices`` [data, model]),
    with the module replicas made on them. A replica is a copy made the first
    time a module is asked for on another device than its own; the module
    itself serves its own device, so replicas that share a device share the
    module. Copies are not refreshed when the module's weights change."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], MODEL_AXIS: devices.shape[1]}
        self._replicas = {}

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data row that computes its slice."""
        return [self.devices[i, 0] for i in range(self.shape[DATA_AXIS])]

    @property
    def first(self) -> torch.device:
        return self.devices[0, 0]

    def replica(self, module: torch.nn.Module, device) -> torch.nn.Module:
        device = _device(device)
        own = module_device(module)
        if own is None or own == device:
            return module
        key = (id(module), device)
        if key not in self._replicas:
            # the module is kept beside its copy so that its id stays taken
            self._replicas[key] = (module, copy.deepcopy(module).to(device))
        return self._replicas[key][1]

    def __repr__(self) -> str:
        return f"FrameMesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def replica_on(module: torch.nn.Module, device, mesh: Optional[FrameMesh] = None):
    """``module``'s replica on ``device`` under ``mesh``; ``module`` itself
    without a mesh."""
    return module if mesh is None else mesh.replica(module, device)


def per_device_chunk(chunk: int, mesh: Optional[FrameMesh] = None) -> int:
    """A stage's chunk that holds ``chunk`` frames for each data device."""
    return chunk * (1 if mesh is None else mesh.shape[DATA_AXIS])


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> FrameMesh:
    """A ``data x model`` ``FrameMesh`` over ``devices`` (every card by
    default; raises without one). ``data_parallel`` -1 takes all that the
    model axis leaves."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh found no CUDA device; pass devices=['cpu', ...] "
                               "to build a mesh on the CPU on purpose")
    devices = [_device(d) for d in devices]
    n = len(devices)
    if data_parallel == -1:
        if n % model_parallel:
            raise ValueError(f"{n} devices do not split into model axis {model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} needs that many devices, "
                         f"got {n}")
    grid = np.empty((data_parallel, model_parallel), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model_parallel, i % model_parallel] = d
    return FrameMesh(grid)


def shard_frames(x: torch.Tensor, mesh: FrameMesh) -> List[torch.Tensor]:
    """The leading axis of ``x`` split into equal slices, slice i on the
    i-th data device. Raises unless the axis divides the data axis."""
    d = mesh.shape[DATA_AXIS]
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} frames do not split over data axis {d}")
    return [s.to(dev) for s, dev in zip(x.chunk(d), mesh.data_devices)]


def shard_frames_if_divisible(x: torch.Tensor, mesh: FrameMesh) -> List[torch.Tensor]:
    """``shard_frames`` when the leading axis divides the data axis; else
    ``x`` whole on the first device (a small tail chunk runs there rather
    than failing)."""
    if x.shape[0] % mesh.shape[DATA_AXIS] == 0:
        return shard_frames(x, mesh)
    return [x.to(mesh.first)]


def replicate(x: torch.Tensor, mesh: FrameMesh) -> List[torch.Tensor]:
    """A copy of ``x`` on every data device."""
    return [x.to(dev) for dev in mesh.data_devices]


def gather_frames(parts: Sequence, mesh: FrameMesh):
    """The inverse of ``shard_frames``: slices (tensors, or tuples of
    tensors) joined along the leading axis on the first device."""
    if torch.is_tensor(parts[0]):
        return torch.cat([p.to(mesh.first) for p in parts])
    return type(parts[0])(gather_frames([p[k] for p in parts], mesh)
                          for k in range(len(parts[0])))


def map_frames(fn: Callable, *xs, mesh: Optional[FrameMesh] = None):
    """``fn(*xs)`` with the leading axis of every tensor in ``xs`` split over
    the mesh's data axis: slice i of each goes to the i-th data device, other
    arguments (None) to every call, and the results (a tensor or a tuple of
    tensors) are gathered on the first device. ``fn`` runs its modules on
    its inputs' device (``FrameMesh.replica``). Without a mesh, or when the
    frames do not divide the data axis, one call on the first device."""
    if mesh is None:
        return fn(*xs)
    n = next(x.shape[0] for x in xs if torch.is_tensor(x))
    if n % mesh.shape[DATA_AXIS]:
        return fn(*[x.to(mesh.first) if torch.is_tensor(x) else x for x in xs])
    d = mesh.shape[DATA_AXIS]
    parts = [shard_frames(x, mesh) if torch.is_tensor(x) else [x] * d for x in xs]
    return gather_frames([fn(*p) for p in zip(*parts)], mesh)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Edge-pad ``axis`` to a multiple of ``multiple``; returns (padded, n)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    edge = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = rem
    return torch.cat([x, edge.repeat(*reps)], dim=axis), n


# ---------------------------------------------------------------------------
# one process per card
# ---------------------------------------------------------------------------


def make_process_mesh(data_parallel: int = -1, model_parallel: int = 1,
                      device_type: Optional[str] = None):
    """A ``DeviceMesh`` of every rank of the initialised default process
    group, ranks laid out row-major as ``data x model`` with
    ``mesh_dim_names`` ("data", "model"). ``device_type`` defaults to
    "cuda" under NCCL and "cpu" otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "s2v_torch.parallel.hosts.initialize)")
    world = dist.get_world_size()
    if data_parallel == -1:
        if world % model_parallel:
            raise ValueError(f"{world} ranks do not split into model axis {model_parallel}")
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} needs that many ranks, "
                         f"got {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(data_parallel, model_parallel),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh):
    """The process group along ``mesh``'s data axis that holds this rank, or
    None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def model_group(mesh):
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.nn.functional import all_reduce

        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return all_reduce(grad.contiguous(), group=ctx.group).chunk(n)[rank], None


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [b, ...] joined in rank order, [world * b, ...],
    with autograd: the backward sums the gradient over the group (through
    the differentiable ``torch.distributed.nn.functional.all_reduce``) and
    takes this rank's rows. Unlike ``torch.distributed.nn.functional.
    all_gather``, whose gloo backward scatters from global ranks, it works
    on any subgroup and backend."""
    if group is None:
        return x
    return _AllGatherCat.apply(x, group)


def allreduce_grads(params: Iterable[torch.Tensor], group, op: str = "mean") -> None:
    """Sum (``op`` "sum") or average (``op`` "mean") the gradients of
    ``params`` over ``group``, in place, through one all-reduce of their
    flattened concatenation. Parameters without a gradient are skipped (every
    rank skips the same ones). A no-op without a group."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if op == "mean":
        flat /= dist.get_world_size(group)
    elif op != "sum":
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def allreduce_mean(values: dict, group) -> dict:
    """0-dim tensors (a step's metrics) averaged over ``group``."""
    if group is None or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(keys, flat.unbind()))


def replicas_agree(tensors: Iterable[torch.Tensor], group) -> bool:
    """True when ``tensors`` (parameters, optimizer state) are bit for bit
    the same on every rank of ``group``: their elementwise max and min over
    the group are equal."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if group is None:
        return True
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))
