"""How the pipeline calls a network: one ``Net`` per (stage, network) of
``TABLE``; a stage says which network it calls, its ``Net`` how. Stages:
``pipeline`` (``LipSyncPipeline``), ``enhancer`` (each ``FaceEnhancer``:
Step 5, the final stage), ``restorer`` and ``mouth`` (the mouth tail's
``GFPGANRestorer`` and ``MouthRestorer``), ``editor`` (``--up_face``).

A call ``net(*args)`` takes the module's replica on ``args[0]``'s device
(``replica_on``); enters the entry's ``precision``, then, where ``timed``,
cuDNN's autotuner (counter ``conv.timed.<name>``); opens the span
``net.<name>``; routes the forward to the module's ``Replay`` where
``replayed`` says so; and calls ``module(*args)`` through ``__call__``, so
that forward hooks see every call.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from s2v_torch.device import constant_on, precision, timed_convolutions
from s2v_torch.models.retinaface import RETINA_MEAN, detect_faces
from s2v_torch.parallel.mesh import replica_on
from s2v_torch.utils import trace
from s2v_torch.utils.graphs import Replay, forward_from


class Entry(NamedTuple):
    name: str               # the span net.<name>
    precision: str          # "f32", "detector" or "generator"
    timed: bool = False     # under cuDNN's autotuner
    replayed: bool = False  # one-frame calls on a card from a CUDA graph


TABLE: Dict[tuple, Entry] = {
    ("pipeline", "s3fd"): Entry("s3fd", "detector"),
    ("pipeline", "fan"): Entry("fan", "detector", timed=True),
    ("pipeline", "recon"): Entry("recon", "f32"),
    ("pipeline", "dnet"): Entry("dnet", "generator"),
    ("pipeline", "enet"): Entry("enet", "generator"),
    ("enhancer", "retinaface"): Entry("retinaface", "detector", replayed=True),
    ("enhancer", "parsenet"): Entry("parsenet", "generator", replayed=True),
    ("enhancer", "facegan"): Entry("gpen", "generator", replayed=True),
    ("enhancer", "srmodel"): Entry("sr", "generator", replayed=True),
    ("restorer", "retinaface"): Entry("retinaface", "detector"),
    ("restorer", "gfpgan"): Entry("gfpgan", "generator"),
    ("mouth", "parsenet"): Entry("parsenet", "detector"),
    ("editor", "ganimation"): Entry("ganimation", "f32"),
}

# why a stage may be built without the network
_WHEN = {"retinaface": " unless landmarks5 are supplied", "facegan": " for face_enhance=True"}


def replayed(stage: str, network: str, device: torch.device, frames: int) -> bool:
    """Whether a call of ``frames`` frames on ``device`` replays: an
    enhancer's network, one frame, on a card. That is the final stage
    (``chunk`` 1 at 2048^2), whose pace the host's dispatch of each op sets;
    a call of more frames (Step 5's 16) dispatches a fraction of that per
    frame, and its graph would pool all its frames' activations. GPEN-2048
    launches the port's own kernels: its ``Replay`` declines it."""
    return TABLE[stage, network].replayed and device.type == "cuda" and frames == 1


class Net:
    """``stage``'s ``network``; ``module()`` gives the module at each call
    (None: the call raises, naming ``owner``). It must not hold the stage:
    the cycle would keep a dropped stage's modules on the card until the
    cycle collector runs. ``dtype``, ``det_dtype``: ``model.dtype``,
    ``model.detector_dtype``. ``replays``: a ``Replay`` per module replica."""

    def __init__(self, stage: str, network: str, module: Callable[[], Optional[nn.Module]],
                 dtype: str = "float32", det_dtype: str = "float32", mesh=None,
                 owner: str = ""):
        self.stage, self.network, self.entry = stage, network, TABLE[stage, network]
        self.span = f"net.{self.entry.name}"
        self.dtype = dict(generator=dtype, detector=det_dtype).get(self.entry.precision, "float32")
        self.module, self.mesh, self.owner = module, mesh, owner
        self.replays: Dict[nn.Module, Replay] = {}

    def __call__(self, *args):
        x = args[0]
        module = self.module()
        if module is None:
            raise ValueError(f"{self.owner} needs a '{self.network}' model"
                             f"{_WHEN.get(self.network, '')}")
        module = replica_on(module, x.device, self.mesh)
        timed = timed_convolutions() if self.entry.timed else contextlib.nullcontext()
        with precision(self.entry.precision, x.device, self.dtype), timed:
            if self.entry.timed:
                trace.count(f"conv.timed.{self.entry.name}")
            with trace.span(self.span), forward_from(module, self._replay(module, x)):
                return module(*args)

    def _replay(self, module: nn.Module, batch: torch.Tensor) -> Optional[Replay]:
        if not replayed(self.stage, self.network, batch.device, len(batch)):
            return None
        if module not in self.replays:
            self.replays[module] = Replay(module, tag=self.span)
        return self.replays[module]


def stage_nets(stage: str, modules: Callable[[str], Optional[nn.Module]],
               **kw) -> Dict[str, Net]:
    """``stage``'s ``Net`` by network, each module looked up as ``modules(network)``."""
    return {network: Net(stage, network, lambda n=network: modules(n), **kw)
            for s, network in TABLE if s == stage}


@torch.no_grad()
def retinaface_detect(net: Net, x: torch.Tensor, threshold: float):
    """RetinaFace through ``net`` on frames [k, 3, H, W] RGB 0..255, BGR and
    mean-subtracted on the device, decoded in f32 (``detect_faces``): the
    best face per frame as (boxes [k, 4], landmarks [k, 5, 2], valid [k]:
    score > ``threshold``)."""
    outs = net(x.flip(1) - constant_on(RETINA_MEAN, x.device).view(1, 3, 1, 1))
    return detect_faces(tuple(o.float() for o in outs), x.shape[2:], threshold)
