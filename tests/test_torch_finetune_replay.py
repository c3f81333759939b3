"""The ENet fine-tune step's replayed LNet (``finetune_enet.Replay``) on the
card: the replayed forward gives the eager forward's output bit for bit,
at each of two batch shapes and with new inputs at every call; a slim step
with LNet replayed gives the eager step's first metrics bit for bit, the
next two steps' within 1e-4 (the backward's weight gradients may sum in
another order from run to run, and Adam's sign-like first moves carry
that on), and leaves every frozen entry as it was.

Every test needs an NVIDIA card; it carries the ``cuda`` marker and skips
elsewhere. The file imports neither jax nor s2v_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_finetune_replay.py
"""

import numpy as np
import pytest
import torch

from s2v_torch.models.enet import ENet
from s2v_torch.train import finetune_enet
from s2v_torch.utils.config import TrainConfig

ENET_KW = dict(num_style_feat=32, lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
               lnet_base_nc=8, lnet_max_nc=32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def batch(n, seed):
    rng = np.random.RandomState(seed)
    return {"mel": rng.randn(n, 80, 16, 1).astype(np.float32),
            "face": rng.rand(n, 96, 96, 6).astype(np.float32),
            "ref": rng.rand(n, 96, 96, 3).astype(np.float32),
            "target": rng.rand(n, 384, 384, 3).astype(np.float32)}


@pytest.mark.cuda
def test_replay_gives_the_eager_forward(card):
    torch.manual_seed(0)
    lnet = ENet(**ENET_KW).low_res.to(card).eval().requires_grad_(False)
    replay = finetune_enet.Replay(lnet)
    for n, seed in ((4, 1), (4, 2), (3, 3), (4, 4)):
        torch.manual_seed(seed)
        audio = torch.randn(n, 1, 80, 16, device=card)
        face = torch.rand(n, 6, 96, 96, device=card)
        with torch.no_grad():
            want = lnet(audio, face)
        got = replay(audio, face).clone()
        assert torch.equal(got, want), (n, seed)
    assert len(replay.graphs) == 2


@pytest.mark.cuda
def test_a_step_with_lnet_replayed_is_the_eager_step(card, monkeypatch):
    def run(replayed):
        torch.manual_seed(0)
        enet = ENet(**ENET_KW)
        if not replayed:
            monkeypatch.setattr(finetune_enet, "Replay", lambda module: None)
        state, step = finetune_enet.make_enet_finetune_step(enet, TrainConfig(), device=card)
        monkeypatch.undo()
        metrics = []
        for seed in (5, 6, 7):
            state, m = step(state, batch(4, seed))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {k: v.detach().cpu() for k, v in enet.state_dict().items()}

    eager, eager_sd = run(False)
    replayed, replayed_sd = run(True)
    assert replayed[0] == eager[0]
    for got, want in zip(replayed[1:], eager[1:]):
        assert got.keys() == want.keys()
        assert all(abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) for k in want), (got, want)
    frozen = [k for k in eager_sd if "style_conv" not in k]
    assert frozen and all(torch.equal(replayed_sd[k], eager_sd[k]) for k in frozen)
