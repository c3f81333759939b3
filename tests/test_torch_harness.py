"""The port's training harness and checkpoints against s2v_tpu's
(s2v_torch/train/harness.py, s2v_torch/utils/checkpoint.py):

- s2v_tpu's three harness tests (tests/test_harness.py) on torch engines
  (a linear regression under SGD 0.1, as there), and the torch ``Engines``
  against the JAX ``Engines`` on the same data from the same ``w``: the
  loss of every step within 1e-5 relative and ``w`` after 20 steps within
  1e-5;
- a slim GPEN ``GANState`` (R1 d_step and g_step taken: Adam moments, EMA,
  step) and a slim ``GFPGANState`` through ``TrainCheckpointer`` into
  states made from other seeds: every parameter, buffer and optimizer
  state bit for bit, and the next step's metrics equal;
- a failing step checkpoints every engine at the global step, then
  re-raises;
- ``save_variables`` / ``load_variables`` and the checkpointer on a dict
  state, mirroring tests/test_training.py's ``test_checkpointer_roundtrip``,
  and a restore into another layout raising with both named.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import test_harness as JH
from s2v_torch.models.gfpgan import GFPGANv1Clean
from s2v_torch.models.gpen import Discriminator, FullGenerator
from s2v_torch.train import gan as TG
from s2v_torch.train import gfpgan_train as TGF
from s2v_torch.train.harness import CommandChannel, Engine, Engines, state_device, train
from s2v_torch.utils.checkpoint import (TrainCheckpointer, load_variables, save_variables,
                                       state_tree)
from s2v_tpu.train import harness as JHarness
from slim_zoo import SLIM_GFPGAN_KW
from torch_dist_ranks import same_tree
from torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def make_engine(seed=0):
    """test_harness.make_engine's regression, its ``w`` from the JAX one."""
    w = nn.Parameter(torch.from_numpy(np.asarray(JH.make_engine(seed).state["w"])))
    state = {"w": w, "opt": torch.optim.SGD([w], lr=0.1)}

    def step(state, batch):
        loss = ((batch["x"] @ state["w"] - batch["y"]) ** 2).mean()
        state["opt"].zero_grad()
        loss.backward()
        state["opt"].step()
        return state, {"loss": loss.detach()}

    return Engine(state=state, step_fn=step, name=f"eng{seed}")


def make_batches(n):
    for b in JH.make_batches(n):
        yield {name: {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
               for name, batch in b.items()}


def test_engines_match_the_jax_engines_step_for_step():
    jax_engines = JHarness.Engines({"a": JH.make_engine(0), "b": JH.make_engine(1)})
    engines = Engines({"a": make_engine(0), "b": make_engine(1)})
    for jb, tb in zip(JH.make_batches(20), make_batches(20)):
        want, got = jax_engines.step(jb), engines.step(tb)
        for name in ("a", "b"):
            np.testing.assert_allclose(got[name]["loss"], want[name]["loss"], rtol=1e-5)
            assert got[name]["elapsed_s"] >= 0
    assert engines.global_step == jax_engines.global_step == 20
    for name in ("a", "b"):
        np.testing.assert_allclose(engines[name].state["w"].detach().numpy(),
                                   np.asarray(jax_engines[name].state["w"]), atol=1e-5)


def test_engines_multi_model_step_and_checkpoint(tmp_path):
    engines = Engines({"a": make_engine(0), "b": make_engine(1)}, checkpoint_dir=str(tmp_path))
    engines = train(engines, make_batches(20), save_every=10, max_steps=20)
    assert engines.global_step == 20
    engines2 = Engines({"a": make_engine(0), "b": make_engine(1)}, checkpoint_dir=str(tmp_path))
    assert engines2.load() == 20
    for name in ("a", "b"):
        assert torch.equal(engines2[name].state["w"], engines[name].state["w"])
        assert (engines2[name].state["opt"].state_dict()
                == engines[name].state["opt"].state_dict())


def test_command_channel_file_and_deferred(tmp_path):
    cmd_file = str(tmp_path / "cmd")
    ch = CommandChannel(cmd_file)
    with open(cmd_file, "w") as f:
        f.write("save")
    assert ch.poll(1) == "save"
    assert not (tmp_path / "cmd").exists()
    with open(cmd_file, "w") as f:
        f.write("eval@5")
    assert ch.poll(2) is None
    assert ch.poll(5) == "eval"


def test_train_quit_command(tmp_path):
    cmd_file = str(tmp_path / "cmd")
    engines = Engines({"a": make_engine(0), "b": make_engine(1)},
                      checkpoint_dir=str(tmp_path / "ck"))
    with open(cmd_file, "w") as f:
        f.write("quit")
    engines = train(engines, make_batches(100), command_file=cmd_file, save_every=0,
                    max_steps=None)
    assert engines.global_step == 1  # quit after the first step, saving
    assert TrainCheckpointer(str(tmp_path / "ck" / "a")).steps() == [1]


def test_a_failing_step_saves_every_engine_then_raises(tmp_path):
    def fails(state, batch):
        raise torch.OutOfMemoryError("out of memory")

    engines = Engines({"a": make_engine(0), "oom": Engine(state={"x": torch.zeros(2)},
                                                          step_fn=fails)},
                      checkpoint_dir=str(tmp_path))
    batches = [{"a": b["a"], "oom": None} for b in make_batches(3)]
    with pytest.raises(torch.OutOfMemoryError):
        train(engines, iter(batches), save_every=0)
    assert engines.global_step == 0
    for name in ("a", "oom"):
        assert TrainCheckpointer(str(tmp_path / name)).steps() == [0]
    stepped = make_engine(0)  # "a" stepped once before "oom" failed
    fresh = Engines({"a": make_engine(0)}, checkpoint_dir=str(tmp_path))
    fresh.load()
    stepped.step(batches[0]["a"])
    assert torch.equal(fresh["a"].state["w"], stepped.state["w"])


ROIS = {"left_eye": 16, "right_eye": 16, "mouth": 24}


def _gan(seed):
    torch.manual_seed(seed)
    g = FullGenerator(size=32, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.125)
    d = Discriminator(size=32, channel_multiplier=1, narrow=0.125)
    return TG.make_gan_trainer(g, d, device="cpu")


def _gfpgan(seed):
    torch.manual_seed(seed)
    g = GFPGANv1Clean(out_size=32, **SLIM_GFPGAN_KW)
    d = Discriminator(size=32, channel_multiplier=1, narrow=0.125)
    comps = {n: TGF.FacialComponentDiscriminator() for n in ROIS}
    state, g_step, d_step = TGF.make_gfpgan_trainer(g, d, comps, device="cpu", roi_sizes=ROIS)
    return state, d_step, g_step


def _batch(seed, n=2, size=32):
    rng = np.random.RandomState(seed)
    batch = {k: rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
             for k in ("lq", "hq", "gt")}
    for name in ROIS:
        batch[f"loc_{name}"] = np.asarray([[9.5, 20.0], [16.0, 12.0]], np.float32)
    return batch


@pytest.mark.parametrize("make", [_gan, _gfpgan], ids=["gan_state", "gfpgan_state"])
def test_trainer_states_round_trip_bit_for_bit(tmp_path, make):
    state, d_step, g_step = make(0)
    batch = _batch(1)
    state, _ = d_step(state, batch)  # R1 in the GAN trainer (step 0)
    state, _ = g_step(state, batch)
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(state.step, state)
    fresh, d_fresh, g_fresh = make(5)
    assert not torch.equal(next(fresh.g.parameters()), next(state.g.parameters()))
    fresh = ck.restore(fresh)
    assert fresh.step == state.step == 1
    assert same_tree(state_tree(fresh), state_tree(state))
    _, want = d_step(state, _batch(2))
    _, got = d_fresh(fresh, _batch(2))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert same_tree(state_tree(fresh), state_tree(state))


def test_save_and_load_variables(tmp_path):
    """test_training.py::test_checkpointer_roundtrip on tensors."""
    tree = {"a": torch.arange(8, dtype=torch.float32), "b": {"c": torch.ones(2, 2)}}
    save_variables(str(tmp_path / "weights"), tree)
    restored = load_variables(str(tmp_path / "weights"), like=tree)
    assert torch.equal(restored["a"], torch.arange(8.0))
    assert torch.equal(restored["b"]["c"], torch.ones(2, 2))
    with pytest.raises(ValueError, match=r"b\.c is \(2, 2\), the tree's \(3, 2\)"):
        load_variables(str(tmp_path / "weights"), like={"a": tree["a"],
                                                        "b": {"c": torch.ones(3, 2)}})
    lin = nn.Linear(3, 2)
    save_variables(str(tmp_path / "linear"), lin)
    other = load_variables(str(tmp_path / "linear"), like=nn.Linear(3, 2))
    assert torch.equal(other.weight, lin.weight) and torch.equal(other.bias, lin.bias)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_variables(str(tmp_path / "linear"), like=nn.Linear(4, 2))

    ck = TrainCheckpointer(str(tmp_path / "train"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((4,), float(step)), "step": step})
    ck.wait()
    assert ck.latest_step() == 3 and ck.steps() == [2, 3]
    got = ck.restore({"w": torch.zeros(4), "step": 0})
    assert torch.equal(got["w"], torch.full((4,), 3.0)) and got["step"] == 3
    with pytest.raises(ValueError, match=r"state\.w is \(5,\), the checkpoint's \(4,\)"):
        ck.restore({"w": torch.zeros(5), "step": 0})


def test_state_device_finds_the_first_tensor():
    state, _, _ = _gan(0)
    assert state_device(state) == torch.device("cpu")
    assert state_device({"n": 1, "w": torch.zeros(1)}) == torch.device("cpu")
    assert state_device({"n": 1}) is None

