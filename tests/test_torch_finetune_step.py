"""One step of the port's ENet fine-tuning (s2v_torch.train.finetune_enet)
against s2v_tpu's on the CPU, f32.

s2v_tpu's ``make_enet_finetune_step`` builds ENet at production width from
variables, so the test rebuilds that body (finetune_enet.py:79-111) from the
JAX package's own functions at the slim ENet of tests/test_torch_models.py:
``l1_loss``, ``perceptual_stub`` or ``vgg_perceptual_loss``, the identity
term of ``make_id_embed_fn`` (at a slim ReconNet: ``make_id_embed_fn``
fixes ResNet50), ``style_conv_mask`` and optax ``multi_transform`` (Adam on
the style convs, set_to_zero on the rest). Held: the metrics within rtol
1e-4; the updated style-conv parameters within lr / 40 on entries whose JAX
gradient exceeds 1e-2 of that parameter's largest (Adam's first step moves
each entry by about lr * sign(g), so an entry whose gradient is within f32
noise of 0 may move the other way); every other parameter and every buffer
(the BatchNorm statistics: ENet stays in eval mode) bit-equal to before. Each variant compiles
its own JAX program (some 20 s), so the VGG16 + identity variant has a file
of its own, test_torch_finetune_vgg_step.py.
"""

import pytest
import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.resnet import ReconNet as TReconNet
from s2v_torch.models.vgg import VGG16Features as TVGG
from s2v_torch.train import finetune_enet as TFE
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models import ENet
from s2v_tpu.models.resnet import ReconNet
from s2v_tpu.models.vgg import VGG16Features, vgg_perceptual_loss
from s2v_tpu.ops.image import resize_bilinear
from s2v_tpu.train import losses as JL
from s2v_tpu.train.finetune import style_conv_mask
from s2v_tpu.utils.config import TrainConfig
from test_torch_models import ENET_KW, load
from torch_parity import one_torch_thread, random_variables

RECON_KW = dict(layers=(1, 1, 1, 1), base_planes=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def _step_inputs(seed=3):
    rng = np.random.RandomState(seed)
    return {"mel": rng.randn(2, 80, 16, 1).astype(np.float32),
            "face": rng.rand(2, 96, 96, 6).astype(np.float32),
            "ref": rng.rand(2, 96, 96, 3).astype(np.float32),
            "target": rng.rand(2, 384, 384, 3).astype(np.float32)}


def jax_finetune_step(variables, batch, cfg, vgg_vars=None, recon_vars=None):
    """finetune_enet.py:79-111 at the slim ENet: (new params, metrics,
    gradients)."""
    model = ENet(**ENET_KW)

    def id_embed(recon, pred01):  # make_id_embed_fn at a slim ReconNet
        return ReconNet(**RECON_KW).apply(recon, resize_bilinear(pred01, (224, 224)))

    def loss_fn(trained, frozen, stats, b, vgg_vars, recon_vars):
        params = {**frozen, **trained}
        pred, _ = model.apply({"params": params, "batch_stats": stats},
                              b["mel"], b["face"], b["ref"])
        loss_l1 = JL.l1_loss(pred, b["target"])
        loss_p = (vgg_perceptual_loss(vgg_vars, pred, b["target"]) if vgg_vars is not None
                  else JL.perceptual_stub(pred, b["target"]))
        loss = cfg.l1_weight * loss_l1 + cfg.perceptual_weight * loss_p
        metrics = {"l1": loss_l1, "perceptual": loss_p}
        if recon_vars is not None:
            ep = id_embed(recon_vars, pred)
            et = jax.lax.stop_gradient(id_embed(recon_vars, b["target"]))
            loss_id = jnp.mean(jnp.square(ep - et))
            loss = loss + cfg.id_weight * loss_id
            metrics["id"] = loss_id
        metrics["loss"] = loss
        return loss, metrics

    params, mask = variables["params"], style_conv_mask(variables["params"])
    labels = jax.tree_util.tree_map(lambda t: "train" if t else "freeze", mask)
    tx = optax.multi_transform({"train": optax.adam(cfg.lr), "freeze": optax.set_to_zero()},
                               labels)
    # differentiate the trainable subtrees only (set_to_zero discards the
    # rest's gradients): the program then has no backward through LNet and
    # the style encoder, and compiles in a fraction of the time
    trained = {k: t for k, t in params.items() if all(jax.tree_util.tree_leaves(mask[k]))}
    assert trained and not any(any(jax.tree_util.tree_leaves(mask[k]))
                               for k in params if k not in trained)
    frozen = {k: t for k, t in params.items() if k not in trained}
    # every array an argument: closed-over arrays become constants that XLA
    # folds at compile time
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trained, frozen, variables["batch_stats"], batch, vgg_vars, recon_vars)
    grads = {k: grads[k] if k in trained else jax.tree_util.tree_map(jnp.zeros_like, t)
             for k, t in params.items()}
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates), metrics, grads


def test_finetune_step_matches_jax():
    """The pyramid perceptual stand-in, no identity term (the VGG16 and
    identity terms: test_torch_finetune_vgg_step.py)."""
    check_finetune_step("stub")


def check_finetune_step(terms):
    v = random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6), (1, 96, 96, 3),
                         seed=4)
    cfg = TrainConfig(lr=1e-3)
    batch = _step_inputs()
    vgg_vars = recon_vars = vgg = embed = None
    if terms == "vgg_id":
        vgg_vars = random_variables(VGG16Features(), (1, 32, 32, 3), seed=5)
        recon_vars = random_variables(ReconNet(**RECON_KW), (1, 224, 224, 3), seed=6)
        vgg = load(TVGG(), TW.vgg16_from_jax(vgg_vars))
        embed = TFE.make_id_embed_fn(load(TReconNet(**RECON_KW),
                                          TW.recon_from_jax(recon_vars)))
    new_params, jm, grads = jax_finetune_step(v, batch, cfg, vgg_vars, recon_vars)

    enet = load(TENet(**ENET_KW), TW.enet_from_jax(v))
    before = {k: t.clone() for k, t in enet.state_dict().items()}
    state, step = TFE.make_enet_finetune_step(enet, t_cfg.TrainConfig(lr=1e-3), device="cpu",
                                              id_embed_fn=embed, vgg=vgg)
    state, m = step(state, batch)
    assert state.step == 1 and not enet.training
    assert set(m) == set(jm) == ({"l1", "perceptual", "loss"} | ({"id"} if embed else set()))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)

    def sd(params):
        return TW.enet_from_jax({"params": jax.tree_util.tree_map(np.asarray, params),
                                 "batch_stats": v["batch_stats"]})

    want, grad = sd(new_params), sd(grads)
    trainable = [k for k, p in enet.named_parameters() if p.requires_grad]
    assert trainable and all(k.startswith("style_convs.") for k in trainable)
    moved = 0
    for k, t in enet.state_dict().items():
        if k in trainable and grad[k].abs().max() > 0:
            g = grad[k].abs()
            keep = g > 1e-2 * g.max()
            moved += not torch.equal(t, before[k])
            np.testing.assert_allclose(t[keep].numpy(), want[k][keep].numpy(), rtol=0,
                                       atol=cfg.lr / 40, err_msg=k)
        else:  # frozen, or a noise strength that the zero noise leaves at gradient 0
            assert torch.equal(t, before[k]), k
    assert moved >= len(trainable) // 2
