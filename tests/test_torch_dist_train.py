"""The port's data-parallel trainers on two gloo ranks (torch_dist_ranks)
against its single-process full-batch trainers and the JAX package's
sharded steps on the CPU, f32.

GPEN (``make_gan_trainer(mesh=...)``, the slim 32^2 nets of
tests/test_torch_train.py, batch 4 from ``face_batches``, two ranks of 2):
step pairs 0-1 with ``d_reg_every`` 2, so R1 runs at step 0 through the
whole-batch minibatch-stddev collective. Held:

- every step's metrics within rtol 1e-5 of the single-process trainer's on
  the whole batch, and within rtol 1e-4 of JAX's ``make_gan_trainer`` on a
  2-device data mesh (f32, summation order);
- every step's gradient (the module stepped, all parameters flattened)
  within 2e-4 relative L2 of the single-process one (measured: 1e-6 at step
  0, 6.5e-5 at step 3, where Adam's sign flips below have moved a few
  entries). With each rank's stddev taken over its own shard instead, the
  gradients differ by 6e-3 to 4e-2 and R1 by 8e-4 relative;
- the parameters and the EMA generator after the four steps within 1e-5
  relative L2 of the single-process ones and 1e-4 of JAX's (Adam's first
  step moves every entry by about lr * sign(g), so an entry whose gradient
  is within f32 noise of 0 may move the other way: see test_torch_train.py);
- G, D, the EMA and both Adam states bit-equal on the two ranks.

ENet fine-tuning (``make_enet_finetune_step(mesh=...)``, the slim ENet of
tests/test_torch_finetune_step.py, batch 2, one frame a rank): two steps'
metrics within rtol 1e-5 of the single-process step on the whole batch, the
first within rtol 1e-4 of the JAX step run with its batch sharded over a
2-device mesh; the trained parameters within 1e-5 relative L2 of the
single-process ones after each step and bit-equal on both ranks; and
``finetune(mesh=...)``'s epoch loop over the global batch (each rank
taking its shard) bit-equal to those two steps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.gpen import Discriminator as TDisc
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.train import finetune_enet as TFE
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models import ENet
from s2v_tpu.models.gpen import Discriminator, FullGenerator
from s2v_tpu.parallel.mesh import make_mesh
from s2v_tpu.prep import degradations as JD
from s2v_tpu.train import gan as JG
from s2v_tpu.utils.config import TrainConfig
from test_torch_finetune_step import _step_inputs, jax_finetune_step
from test_torch_models import ENET_KW, load
from test_torch_train import D_KW, G_KW, SIZE
from torch_parity import one_torch_thread, random_variables
import torch_dist_ranks


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def flat(params, keys=None):
    """The parameters of ``keys`` (all of ``params`` by default) in one vector."""
    return np.concatenate([params[k].ravel() for k in sorted(keys or params)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gen, disc = FullGenerator(**G_KW), Discriminator(**D_KW)
    gv = random_variables(gen, (1, SIZE, SIZE, 3), seed=5, equalized=True)
    dv = random_variables(disc, (1, SIZE, SIZE, 3), seed=6, equalized=True)
    imgs = (np.random.RandomState(7).rand(4, SIZE, SIZE, 3) * 255).astype(np.uint8)
    batch = next(JD.face_batches(imgs, batch_size=4, rng=np.random.default_rng(7), steps=1))
    ev = random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6), (1, 96, 96, 3),
                          seed=4)
    enet_batch = _step_inputs()
    refs = dict(g_kw=G_KW, d_kw=D_KW, batch=batch,
                g_sd={k: v.numpy() for k, v in TW.gpen_from_jax(gv).items()},
                d_sd={k: v.numpy() for k, v in TW.gpen_disc_from_jax(dv).items()},
                enet_kw=ENET_KW, enet_batch=enet_batch,
                enet_sd={k: v.numpy() for k, v in TW.enet_from_jax(ev).items()})

    # JAX: the sharded steps on a 2-device data mesh
    mesh = make_mesh(data_parallel=2, model_parallel=1, devices=jax.devices()[:2])
    jstate, jd_step, jg_step = JG.make_gan_trainer(
        lambda p, x: gen.apply({"params": p}, x, deterministic=True),
        lambda p, x: disc.apply({"params": p}, x), gv["params"], dv["params"], mesh=mesh,
        d_reg_every=2)
    jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
              for k, v in batch.items()}
    jmetrics = []
    with mesh:
        for _ in range(2):
            jstate, dm = jd_step(jstate, jbatch)
            jstate, gm = jg_step(jstate, jbatch)
            jmetrics += [{k: float(v) for k, v in m.items()} for m in (dm, gm)]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jax_gan = dict(metrics=jmetrics,
                   g={k: v.numpy() for k, v in TW.gpen_from_jax(
                       {"params": to_np(jstate.g_params)}).items()},
                   d={k: v.numpy() for k, v in TW.gpen_disc_from_jax(
                       {"params": to_np(jstate.d_params)}).items()},
                   g_ema={k: v.numpy() for k, v in TW.gpen_from_jax(
                       {"params": to_np(jstate.g_ema)}).items()})
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
               for k, v in enet_batch.items()}
    with mesh:
        _, jax_enet_metrics, _ = jax_finetune_step(ev, sharded, TrainConfig(lr=1e-3))

    # the port on one process, the whole batch
    with one_torch_thread():
        single = torch_dist_ranks.run_gan(TGPEN(**G_KW), TDisc(**D_KW), refs)
        single.pop("state")
        enet = load(TENet(**ENET_KW), TW.enet_from_jax(ev))
        st, step = TFE.make_enet_finetune_step(enet, t_cfg.TrainConfig(lr=1e-3), device="cpu")
        single_enet = torch_dist_ranks.run_enet(step, st, enet_batch)
    ranks = torch_dist_ranks.spawn(torch_dist_ranks.train_ranks, 2,
                                   tmp_path_factory.mktemp("train_group"), refs)
    return dict(ranks=ranks, single=single, jax_gan=jax_gan, single_enet=single_enet,
                jax_enet_metrics={k: float(v) for k, v in jax_enet_metrics.items()})


def test_gan_steps_match_the_full_batch_and_jax(runs):
    single, jax_gan = runs["single"], runs["jax_gan"]
    for r in runs["ranks"]:
        gan = r["gan"]
        assert gan["replicas_agree"]
        assert gan["steps"][0]["metrics"]["r1"] > 0 and gan["steps"][2]["metrics"]["r1"] == 0
        for k, (got, want) in enumerate(zip(gan["steps"], single["steps"])):
            for key, value in want["metrics"].items():
                np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-5,
                                           err_msg=f"step {k} {key}")
                np.testing.assert_allclose(got["metrics"][key], jax_gan["metrics"][k][key],
                                           rtol=1e-4, err_msg=f"step {k} {key} vs JAX")
            assert rel_l2(got["grads"], want["grads"]) < 2e-4, k
        for name in ("g", "d", "g_ema"):
            assert rel_l2(flat(gan[name]), flat(single[name])) < 1e-5, name
            assert rel_l2(flat(gan[name]), flat(jax_gan[name], gan[name])) < 1e-4, name


def test_enet_steps_match_the_full_batch_and_jax(runs):
    single = runs["single_enet"]["steps"]
    for r in runs["ranks"]:
        enet = r["enet"]
        assert enet["replicas_agree"]
        for k, (got, want) in enumerate(zip(enet["steps"], single)):
            for key, value in want["metrics"].items():
                np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-5,
                                           err_msg=f"step {k} {key}")
            assert rel_l2(flat(got["params"]), flat(want["params"])) < 1e-5, k
        # finetune's loop over the global batch: the same two steps
        assert enet["finetune"]["steps"] == 2
        for k, v in enet["finetune"]["params"].items():
            np.testing.assert_array_equal(v, enet["steps"][1]["params"][k], err_msg=k)
        for key, value in runs["jax_enet_metrics"].items():
            np.testing.assert_allclose(enet["steps"][0]["metrics"][key], value, rtol=1e-4,
                                       err_msg=key)
