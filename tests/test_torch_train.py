"""The port's GPEN adversarial trainer (s2v_torch.train.gan) and its data
chain (s2v_torch.prep.degradations) against the JAX package on the CPU.

The trainer runs at size 32 (the geometry of tests/test_gan_training.py)
from the same random weights and the same face_batches batch on both sides:
one R1 d_step (step 0), one g_step and one plain d_step (step 1), each
started from the JAX trainer's parameters of the moment. Held:

- metrics, rtol 1e-4 (f32, summation order);
- every parameter gradient against jax.grad of the same loss built from the
  JAX package's loss functions, atol 1e-3 of that parameter's largest
  gradient (the port's Functions on the CPU run the plain versions; a
  one-element noise strength, a sum over batch and space with cancellation,
  measured 1.8e-4);
- updated parameters, atol lr / 40 = 5e-5, on entries whose gradient exceeds
  1e-2 of the parameter's largest: Adam with b1 = 0 moves every entry by
  about lr * sign(g) on its first step, so an entry whose gradient is within
  f32 noise of 0 may move the other way (2 * lr apart), and on later steps
  by lr times a ratio of gradients, which carries their relative error
  (measured worst 1.0e-5); other betas, eps or bias corrections move entries
  by a fraction of lr;
- the EMA generator, atol 2e-5 everywhere ((1 - decay) * 2 * lr bounds the
  effect of such an entry), and ``step``.

face_batches must equal the JAX package's bit for bit, JPEG included.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2v_torch.ops.kernels  # noqa: F401  (registers the kernel modules)
from s2v_torch.models.gpen import Discriminator as TDisc
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.prep import degradations as TD
from s2v_torch.train import gan as TG
from s2v_torch.utils import weights as TW
from s2v_tpu.models.gpen import Discriminator, FullGenerator
from s2v_tpu.prep import degradations as JD
from s2v_tpu.train import gan as JG
from torch_parity import one_torch_thread, random_variables

SIZE = 32
G_KW = dict(size=SIZE, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.25)
D_KW = dict(size=SIZE, channel_multiplier=1, narrow=0.25)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("name", ["d_logistic_loss", "g_nonsaturating_loss",
                                  "smooth_l1", "smooth_l1_beta"])
def test_losses_match_jax(name):
    rng = np.random.RandomState(1)
    real, fake = rng.randn(8, 1).astype(np.float32), rng.randn(8, 1).astype(np.float32)
    a, b = (rng.randn(4, 8, 8, 3).astype(np.float32) * 2 for _ in range(2))
    args, kw, fn = {
        "d_logistic_loss": ((real, fake), {}, "d_logistic_loss"),
        "g_nonsaturating_loss": ((fake,), {}, "g_nonsaturating_loss"),
        "smooth_l1": ((a, b), {}, "smooth_l1"),
        "smooth_l1_beta": ((a, b), {"beta": 0.5}, "smooth_l1"),
    }[name]
    want = float(getattr(JG, fn)(*map(jnp.asarray, args), **kw))
    got = float(getattr(TG, fn)(*map(_t, args), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(2)
    e, p = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    want = JG.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.9)["w"]
    me, mp = torch.nn.Linear(3, 5, bias=False), torch.nn.Linear(3, 5, bias=False)
    me.weight.data, mp.weight.data = _t(e), _t(p)
    TG.ema_update(me, mp, 0.9)
    np.testing.assert_allclose(me.weight.detach().numpy(), want, rtol=0, atol=1e-7)


def _disc(seed=3):
    model = Discriminator(**D_KW)
    v = random_variables(model, (1, SIZE, SIZE, 3), seed=seed, equalized=True)
    port = TDisc(**D_KW)
    port.load_state_dict(TW.gpen_disc_from_jax(v))
    return model, v, port


def _grads_sd(conv, grads):
    return conv({"params": jax.tree_util.tree_map(np.asarray, grads)})


def assert_grads(port, want_sd):
    """No gradient on the port's side (a parameter the loss does not reach,
    as R1 does not reach the biases after the stddev channel) must be an
    all-zero one on the JAX side."""
    for name, p in port.named_parameters():
        want = want_sd[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)


def test_r1_penalty_and_its_gradient_match_jax():
    rng = np.random.RandomState(4)
    model, v, port = _disc()
    real = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)

    def r1(params):
        return JG.r1_penalty(lambda p, x: model.apply({"params": p}, x), params,
                             jnp.asarray(real))

    want, grads = jax.jit(jax.value_and_grad(r1))(v["params"])
    got = TG.r1_penalty(port, _t(real).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    got.backward()
    assert_grads(port, _grads_sd(TW.gpen_disc_from_jax, grads))


def _flat_params(module):
    return {k: p.detach().numpy().copy() for k, p in module.named_parameters()}


def _jax_d_grads(gen, disc, batch, d_reg_every=16, r1_weight=10.0):
    """jax.grad of the JAX trainer's D loss, built from its functions."""
    def loss(d_params, g_params, do_r1):
        fake = jax.lax.stop_gradient(gen.apply({"params": g_params}, batch["lq"],
                                               deterministic=True))
        dapply = lambda p, x: disc.apply({"params": p}, x)  # noqa: E731
        out = JG.d_logistic_loss(dapply(d_params, batch["hq"]), dapply(d_params, fake))
        r1 = JG.r1_penalty(dapply, d_params, batch["hq"])
        return out + do_r1 * (r1_weight / 2.0) * r1 * d_reg_every

    return jax.jit(jax.grad(loss))


def _jax_g_grads(gen, disc, batch):
    def loss(g_params, d_params):
        fake = gen.apply({"params": g_params}, batch["lq"], deterministic=True)
        pred = disc.apply({"params": d_params}, fake)
        return JG.g_nonsaturating_loss(pred) + JG.smooth_l1(fake, batch["hq"])

    return jax.jit(jax.grad(loss))


def test_trainer_steps_match_jax():
    gen, disc = FullGenerator(**G_KW), Discriminator(**D_KW)
    gv = random_variables(gen, (1, SIZE, SIZE, 3), seed=5, equalized=True)
    dv = random_variables(disc, (1, SIZE, SIZE, 3), seed=6, equalized=True)
    imgs = (np.random.RandomState(7).rand(4, SIZE, SIZE, 3) * 255).astype(np.uint8)
    batch = next(JD.face_batches(imgs, batch_size=4, rng=np.random.default_rng(7), steps=1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jstate, jd_step, jg_step = JG.make_gan_trainer(
        lambda p, x: gen.apply({"params": p}, x, deterministic=True),
        lambda p, x: disc.apply({"params": p}, x),
        gv["params"], dv["params"], mesh=None)
    g_port, d_port = TGPEN(**G_KW), TDisc(**D_KW)
    g_port.load_state_dict(TW.gpen_from_jax(gv))
    d_port.load_state_dict(TW.gpen_disc_from_jax(dv))
    state, d_step, g_step = TG.make_gan_trainer(g_port, d_port, device="cpu")
    d_grads, g_grads = _jax_d_grads(gen, disc, jbatch), _jax_g_grads(gen, disc, jbatch)

    def check_params(module, jparams, conv, grads_sd):
        want = conv({"params": jax.tree_util.tree_map(np.asarray, jparams)})
        for name, got in _flat_params(module).items():
            g = np.abs(grads_sd[name].numpy())
            keep = g > 1e-2 * g.max()
            np.testing.assert_allclose(got[keep], want[name].numpy()[keep], rtol=0,
                                       atol=5e-5, err_msg=name)

    def check_metrics(got, want):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)

    def sync():
        """Start each step from the JAX state's parameters (in place, so the
        optimizers keep their hold), so that each step is compared at one
        point and not after the Adam caveat above has moved some entries."""
        for module, tree, conv in ((state.g, jstate.g_params, TW.gpen_from_jax),
                                   (state.d, jstate.d_params, TW.gpen_disc_from_jax)):
            module.load_state_dict(conv({"params": jax.tree_util.tree_map(np.asarray, tree)}))

    for kind, do_r1 in (("d", 1.0), ("g", None), ("d", 0.0)):
        sync()
        if kind == "d":
            want_g = _grads_sd(TW.gpen_disc_from_jax,
                               d_grads(jstate.d_params, jstate.g_params, do_r1))
            jstate, jm = jd_step(jstate, jbatch)
            state, m = d_step(state, batch)
            assert (float(m["r1"]) > 0) == bool(do_r1)
            assert_grads(state.d, want_g)
            check_params(state.d, jstate.d_params, TW.gpen_disc_from_jax, want_g)
        else:
            want_g = _grads_sd(TW.gpen_from_jax, g_grads(jstate.g_params, jstate.d_params))
            d_before = [p.grad.clone() for p in state.d.parameters()]
            jstate, jm = jg_step(jstate, jbatch)
            state, m = g_step(state, batch)
            for p, before in zip(state.d.parameters(), d_before):  # D took no gradient
                assert p.requires_grad and torch.equal(p.grad, before)
            assert_grads(state.g, want_g)
            check_params(state.g, jstate.g_params, TW.gpen_from_jax, want_g)
            want_ema = TW.gpen_from_jax({"params": jax.tree_util.tree_map(
                np.asarray, jstate.g_ema)})
            for name, got in _flat_params(state.g_ema).items():
                np.testing.assert_allclose(got, want_ema[name].numpy(), rtol=0, atol=2e-5,
                                           err_msg=name)
        check_metrics(m, jm)
    assert state.step == int(jstate.step) == 1


def test_g_step_with_identity_embedding():
    """The optional identity term: 1 - <embed(fake), embed(hq)> averaged
    over the batch, the real side without gradient, added with id_weight;
    g_adv stays the adversarial loss plus the weighted L1."""
    def embed(images):  # a unit vector per image from its channel means
        v = images.mean(dim=(2, 3))
        return v / v.norm(dim=-1, keepdim=True)

    torch.manual_seed(1)
    g = TGPEN(size=SIZE, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.125)
    d = TDisc(size=SIZE, channel_multiplier=1, narrow=0.125)
    rng = np.random.RandomState(9)
    batch = {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for k in ("lq", "hq")}
    with torch.no_grad():
        fake = g(_t(batch["lq"]).permute(0, 3, 1, 2))
        want_id = (1 - (embed(fake) * embed(_t(batch["hq"]).permute(0, 3, 1, 2))).sum(-1)).mean()
    state, _, g_step = TG.make_gan_trainer(g, d, device="cpu", id_weight=0.5, id_embed_fn=embed)
    _, m = g_step(state, batch)
    np.testing.assert_allclose(m["id"].item(), want_id.item(), rtol=1e-5)
    np.testing.assert_allclose(m["g_loss"].item(), m["g_adv"].item() + 0.5 * m["id"].item(),
                               rtol=1e-6)


def test_trainer_launch_counts_follow_the_layers(monkeypatch):
    """Each step kind calls the kernels' versions as often as
    expected_train_launches derives from the models' K1 and K3 sites (here
    counted on the plain versions, which a CUDA run replaces one for one by
    launches)."""
    fa = sys.modules["s2v_torch.ops.kernels.fused_act"]
    ud = sys.modules["s2v_torch.ops.kernels.upfirdn2d"]
    counts = dict.fromkeys(("fused_act", "fused_act_bwd", "upfirdn2d"), 0)

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def run(*a, **k):
            counts[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, run)

    counted(fa, "fused_bias_leaky_relu_plain", "fused_act")
    counted(fa, "fused_bias_leaky_relu_bwd_plain", "fused_act_bwd")
    counted(ud, "upfirdn2d_plain", "upfirdn2d")
    torch.manual_seed(0)
    g = TGPEN(size=SIZE, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.125)
    d = TDisc(size=SIZE, channel_multiplier=1, narrow=0.125)
    want = TG.expected_train_launches(g, d)
    state, d_step, g_step = TG.make_gan_trainer(g, d, device="cpu", d_reg_every=2)
    rng = np.random.RandomState(8)
    batch = {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for k in ("lq", "hq")}
    for kind, step in (("d_r1", d_step), ("g", g_step), ("d", d_step)):
        for k in counts:
            counts[k] = 0
        state, _ = step(state, batch)
        assert counts == want[kind], kind


@pytest.mark.parametrize("seed,jpeg", [(0, True), (1, True), (2, True), (3, False)])
def test_face_batches_equal_jax_bit_for_bit(seed, jpeg):
    """The default chain, JPEG included, and (seed 3) the chain with the
    JPEG step off, as chip_smoke.py runs it."""
    imgs = (np.random.RandomState(9).rand(3, 48, 48, 3) * 255).astype(np.uint8)
    kw = {} if jpeg else dict(jpeg_range=None)
    want = list(JD.face_batches(imgs, 2, rng=np.random.default_rng(seed), steps=2,
                                degrader=JD.GFPGANDegrader(**kw)))
    got = list(TD.face_batches(imgs, 2, rng=np.random.default_rng(seed), steps=2,
                               degrader=TD.GFPGANDegrader(**kw)))
    for w, g in zip(want, got):
        assert set(w) == set(g) == {"lq", "hq"}
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_trainer_refuses_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.make_gan_trainer(TGPEN(**G_KW), TDisc(**D_KW))

