"""Graph replay (``s2v_torch/utils/graphs.py``) on the CPU: a module whose
first call launches one of the port's own kernels is declined and stays
eager; ``forward_from`` routes a module's calls through its own hooks; the
final stage's ``FaceEnhancer`` on the CPU replays nothing, opens no
``graph.*`` span and gives what the plain call of each network gave. The
replays themselves run on the card: tests/test_torch_cuda.py and
tests/test_torch_finetune_replay.py."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from s2v_torch.models.parsenet import ParseNet
from s2v_torch.models.retinaface import retinaface_mnet
from s2v_torch.models.rrdbnet import RRDBNet
from s2v_torch.parallel.mesh import replica_on
from s2v_torch.pipeline import enhance
from s2v_torch.utils import trace
from s2v_torch.utils.graphs import Replay, forward_from
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _empty_ring():
    trace.reset()
    with one_torch_thread():
        yield
    trace.reset()


class Launching(nn.Module):
    """A module whose forward counts a launch of K1, as the kernels do."""

    def forward(self, x):
        trace.count("kernel.launch.fused_act")
        return x * 2.0


def test_a_module_that_launches_the_ports_kernels_is_declined_and_stays_eager():
    module = Launching()
    replay = Replay(module, tag="net.gpen")
    assert replay.declined is None
    for i in range(3):
        x = torch.full((1, 3), float(i))
        assert torch.equal(replay(x), x * 2.0)
    assert replay.declined is True and not replay.graphs
    assert trace.counter("kernel.launch.fused_act") == 3
    assert not [r for r in trace.records() if r.name.startswith("graph.")]


def test_the_first_call_runs_eagerly_and_accepts_a_module_without_the_kernels():
    module = nn.Linear(3, 2)
    replay = Replay(module, tag="net.sr")
    x = torch.randn(1, 3)
    assert torch.equal(replay(x), module(x)) and replay.declined is False
    assert not replay.graphs


def test_forward_from_routes_the_modules_calls_through_its_hooks():
    module = nn.Linear(3, 2)
    seen = []
    module.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape))
    x = torch.randn(4, 3)
    with forward_from(module, lambda a: a + 1.0):
        assert torch.equal(module(x), x + 1.0)
    assert "forward" not in vars(module) and torch.equal(module(x), nn.Linear.forward(module, x))
    with forward_from(module, None):
        assert torch.equal(module(x), nn.Linear.forward(module, x))
    assert seen == [x.shape] * 3


def test_the_final_stage_on_the_cpu_replays_nothing(monkeypatch):
    """``FaceEnhancer`` at ``in_size`` 1024 (one frame a call, as the final
    stage's 2048) with SR, RetinaFace and ParseNet, slim, GPEN left out
    (``face_enhance=False``): no ``Replay``, no ``graph.*`` span, one
    ``net.*`` span per network per frame, and the frames that the plain
    call of each network gives, bit for bit."""
    torch.manual_seed(3)
    retina = retinaface_mnet()
    with torch.no_grad():
        retina.ClassHead[2].conv1x1.bias[[1, 3]] += 4.0
    models = dict(retinaface=retina.eval(),
                  parsenet=ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=2).eval(),
                  srmodel=RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8).eval())
    frames = (np.random.RandomState(4).rand(2, 48, 48, 3) * 255).astype(np.uint8)

    def run():
        enh = enhance.FaceEnhancer(models, in_size=1024, dtype="float32", parse_size=64,
                                   device="cpu")
        assert enh.chunk == 1
        return enh.process_batch(frames, face_enhance=False), enh

    got, enh = run()
    assert not enh._replays
    names = [r.name for r in trace.records()]
    assert not [n for n in names if n.startswith("graph.")]
    assert sorted(n for n in names if n.startswith("net.")) == (
        ["net.parsenet"] * 2 + ["net.retinaface"] * 2 + ["net.sr"] * 2)

    def plain_run(self, name, x, *args, why=""):
        return trace.call(enhance.NET_SPANS[name],
                          replica_on(self.models[name], x.device, self.mesh), *args)

    monkeypatch.setattr(enhance.FaceEnhancer, "_run", plain_run)
    want, _ = run()
    assert got.shape == (2, 96, 96, 3) and torch.equal(got, want)
