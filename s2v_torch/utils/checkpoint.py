"""Checkpointing (s2v_tpu/utils/checkpoint.py), with ``torch.save`` in place
of orbax:

1. Model weights: ``save_variables`` / ``load_variables`` of a module's
   ``state_dict`` or of a tree of tensors.
2. Training resume: ``TrainCheckpointer``, step-indexed checkpoints of a
   trainer's whole state (the DeepSpeed save_checkpoint/load_checkpoint
   analogue of the reference, emb/utils/engines.py:95-111).

Every file is written to a temporary name and then renamed, so a reader
never sees half a file, and read with ``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch
import torch.nn as nn

_NAME = re.compile(r"^step_(\d+)(?:\.rank(\d+)-of-(\d+))?\.pt$")


def _write(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensors(tree, where: str = "") -> dict:
    """path -> tensor of a nested dict of tensors."""
    if torch.is_tensor(tree):
        return {where: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"{where or 'the tree'}: {type(tree).__name__} is not a tensor or dict")
    out = {}
    for k, v in tree.items():
        out.update(_tensors(v, f"{where}.{k}" if where else str(k)))
    return out


def save_variables(path: str, variables) -> None:
    """Save a module's ``state_dict`` (parameters and buffers) or a nested
    dict of tensors."""
    tree = variables.state_dict() if isinstance(variables, nn.Module) else variables
    _write({k: v.detach().cpu() for k, v in _tensors(tree).items()}, os.path.abspath(path))


def load_variables(path: str, like=None):
    """The saved tensors as a flat ``{path: tensor}`` dict, or, with
    ``like``: a module loaded strictly and returned, or a dict of tensors
    with ``like``'s nesting, which must have the same keys and shapes."""
    flat = _read(os.path.abspath(path))
    if like is None:
        return flat
    if isinstance(like, nn.Module):
        like.load_state_dict(flat, strict=True)
        return like
    want = _tensors(like)
    if want.keys() != flat.keys():
        raise KeyError(f"{path} holds {sorted(flat)}, the tree {sorted(want)}")
    for k, t in want.items():
        if t.shape != flat[k].shape:
            raise ValueError(f"{path}: {k} is {tuple(flat[k].shape)}, the tree's {tuple(t.shape)}")

    def rebuild(tree, where=""):
        if torch.is_tensor(tree):
            return flat[where]
        return {k: rebuild(v, f"{where}.{k}" if where else str(k)) for k, v in tree.items()}

    return rebuild(like)


def _local_optimizer(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """A ZeRO-1 optimizer's own shard (its ``optim``: this rank's partition
    of the state); any other optimizer itself."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt


def _host_copy(tree):
    """Every tensor of a nested dict / list copied to the host."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def state_tree(state) -> Any:
    """What a checkpoint holds of a trainer's state, by one walk over a
    dataclass's or dict's fields: a module's parameters and buffers, an
    optimizer's ``state_dict`` (a ZeRO-1 optimizer's own shard), tensors,
    numbers and nested dicts; every tensor a copy on the host. A state with
    a ``checkpoint_tree()`` method gives its own tree (and takes it back
    through ``load_checkpoint_tree``)."""
    if hasattr(state, "checkpoint_tree"):
        return _host_copy(state.checkpoint_tree())
    if isinstance(state, nn.Module):
        return _host_copy(state.state_dict())
    if isinstance(state, torch.optim.Optimizer):
        return _host_copy(_local_optimizer(state).state_dict())
    if torch.is_tensor(state):
        return _host_copy(state)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: state_tree(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: state_tree(v) for k, v in state.items()}
    if state is None or isinstance(state, (bool, int, float, str)):
        return state
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def restore_tree(state, saved, where: str = "state"):
    """Load ``saved`` (a ``state_tree``) into ``state`` in place where it
    holds modules, optimizers and tensors; returns the state with its numbers
    replaced. Keys and shapes must match."""
    if hasattr(state, "load_checkpoint_tree"):
        return state.load_checkpoint_tree(saved)
    if isinstance(state, nn.Module):
        state.load_state_dict(saved, strict=True)
        return state
    if isinstance(state, torch.optim.Optimizer):
        live = _local_optimizer(state)
        want = [len(g["params"]) for g in live.param_groups]
        got = [len(g["params"]) for g in saved["param_groups"]]
        if want != got:
            raise ValueError(f"{where} steps parameter groups of {want} tensors, the "
                             f"checkpoint's {got}")
        live.load_state_dict(saved)
        return state
    if torch.is_tensor(state):
        if state.shape != saved.shape:
            raise ValueError(f"{where} is {tuple(state.shape)}, the checkpoint's "
                             f"{tuple(saved.shape)}")
        with torch.no_grad():
            state.copy_(saved)
        return state
    fields = ([f.name for f in dataclasses.fields(state)] if dataclasses.is_dataclass(state)
              else list(state) if isinstance(state, dict) else None)
    if fields is None:
        return saved
    if set(fields) != set(saved):
        raise KeyError(f"{where} has {sorted(fields)}, the checkpoint {sorted(saved)}")
    for name in fields:
        value = restore_tree(state[name] if isinstance(state, dict) else getattr(state, name),
                             saved[name], f"{where}.{name}")
        if isinstance(state, dict):
            state[name] = value
        else:
            setattr(state, name, value)
    return state


def _rank_world() -> tuple:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class TrainCheckpointer:
    """``save(step, state)`` / ``restore(state, step=None)`` (None: the
    latest) of any trainer state (``state_tree``: ``GANState``,
    ``GFPGANState``, ``ArcFaceState``, a fine-tune's ``TrainState``, a
    dict); keeps the newest ``max_to_keep`` steps. Saves are synchronous, so
    ``wait`` returns at once.

    In a process group of more than one rank such a state may differ by
    rank (PartialFC's class shard, a ZeRO-1 optimizer's shard), and the walk
    cannot tell a replica from a shard, so with ``per_rank`` (the default)
    every rank writes its own file, ``step_<n>.rank<r>-of-<world>.pt``, and
    restores only its own, in a group of the same size: any other layout,
    and any tensor of another shape, raises an error that names both. A
    caller whose state is a replica that one rank alone writes passes
    ``per_rank=False``: one ``step_<n>.pt`` for the group."""

    def __init__(self, directory: str, max_to_keep: int = 3, per_rank: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.per_rank = per_rank
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        rank, world = _rank_world()
        suffix = f".rank{rank}-of-{world}" if self.per_rank and world > 1 else ""
        return os.path.join(self.directory, f"step_{step}{suffix}.pt")

    def _files(self) -> list:
        """(step, world size, name) of every checkpoint file."""
        return [(int(m.group(1)), int(m.group(3) or 1), name)
                for name in os.listdir(self.directory) for m in [_NAME.match(name)] if m]

    def steps(self) -> list:
        return sorted({f[0] for f in self._files()})

    def save(self, step: int, state) -> None:
        _write(state_tree(state), self._path(step))
        kept = sorted(s for s, _, name in self._files()
                      if name == os.path.basename(self._path(s)))
        for old in kept[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state, step: Optional[int] = None):
        """Loads the checkpoint into ``state`` in place and returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        if not os.path.isfile(path):
            layouts = sorted({f"{w} ranks" if w > 1 else "one process"
                              for s, w, _ in self._files() if s == step})
            rank, world = _rank_world()
            raise ValueError(f"step {step} in {self.directory} was saved by "
                             f"{', '.join(layouts) or 'no process'}; this is rank {rank} of "
                             f"{world}, which needs {os.path.basename(path)}")
        return restore_tree(state, _read(path))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        pass
