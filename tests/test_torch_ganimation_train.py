"""The port's GANimation/StarGAN trainer (s2v_torch.train.ganimation_train)
against s2v_tpu.train.ganimation_train on the CPU, f32, with the JAX tests'
tiny generator (SplitGenerator, ngf 8, one block, 32^2) and their linear
critic (score = sum(x * w), AUs = the channel means @ wa), plus a
quadratic one whose input gradient depends on the interpolate, both
defined here on each side; inputs from numpy seeds.

- ``tv_loss`` within 1e-6 relative.
- The penalty, each d-loss and each g-loss, given the same interpolation
  weight (JAX's draw from its key): metrics within 1e-5 relative, the
  gradients to the critic (d) and the generator (g) within 1e-4 relative
  L2 per tensor (the conv biases that an instance norm follows, whose
  gradient is 0 but for rounding, within 1e-6 of the whole gradient's
  norm on both sides).
- One ``make_expression_trainer`` d_step then g_step for each model, the
  port's interpolation weight replaced by JAX's draw: metrics within 1e-4
  relative; the gradients, read from each Adam's first moment (which is
  (1 - b1) g after one step), within 1e-4 relative L2; the d_step leaves
  the generator as it was, the g_step leaves the critic and its gradients
  as the d_step left them.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from s2v_torch.models.ganimation import SplitGenerator as TGen
from s2v_torch.train import ganimation_train as TGT
from s2v_torch.utils.weights import ganimation_from_jax
from s2v_tpu.models.ganimation import SplitGenerator as JGen
from s2v_tpu.train import ganimation_train as JGT
from torch_parity import one_torch_thread, random_variables

SIZE, B, LR = 32, 2, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def jax_critic(quadratic):
    def disc_apply(params, x):
        s = x * params["w"]
        score = jnp.sum(s, axis=(1, 2, 3))[:, None]
        if quadratic:
            score = score + 0.5 * jnp.sum(s * s, axis=(1, 2, 3))[:, None]
        return score, jnp.mean(x, axis=(1, 2)) @ params["wa"]
    return disc_apply


class Critic(nn.Module):
    """The same critics, NCHW."""

    def __init__(self, w, wa, quadratic):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(np.asarray(w).transpose(0, 3, 1, 2).copy()))
        self.wa = nn.Parameter(torch.from_numpy(np.asarray(wa).copy()))
        self.quadratic = quadratic

    def forward(self, x):
        s = x * self.w
        score = s.sum((1, 2, 3))[:, None]
        if self.quadratic:
            score = score + 0.5 * (s * s).sum((1, 2, 3))[:, None]
        return score, x.mean((2, 3)) @ self.wa


def models(quadratic):
    rng = np.random.RandomState(261)
    g_vars = random_variables(JGen(ngf=8, n_blocks=1), (1, SIZE, SIZE, 3), (1, 17), seed=2)
    d_params = {"w": rng.randn(1, SIZE, SIZE, 3).astype(np.float32) * 0.01,
                "wa": rng.randn(3, 17).astype(np.float32) * 0.1}
    gen = TGen(ngf=8, n_blocks=1)
    gen.load_state_dict(ganimation_from_jax(g_vars), strict=True)
    critic = Critic(d_params["w"], d_params["wa"], quadratic)

    def gen_apply(params, img, aus):
        return JGen(ngf=8, n_blocks=1).apply(params, img, aus)

    return gen_apply, g_vars, jax_critic(quadratic), d_params, gen, critic


def batch(seed=5):
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    return src, rng.rand(B, 17).astype(np.float32), rng.rand(B, 17).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def jax_alpha(key):
    return np.array(jax.random.uniform(key, (B, 1, 1, 1)))


def metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-7, err_msg=k)


def critic_grads_close(grads_t, grads_j, tol):
    for name, j in (("w", np.asarray(grads_j["w"]).transpose(0, 3, 1, 2)), ("wa", grads_j["wa"])):
        g = np.zeros(np.shape(j), np.float32) if grads_t[name] is None else grads_t[name]
        if np.abs(np.asarray(j)).max() == 0:  # no path to the term: None here, 0 in JAX
            assert np.abs(np.asarray(g)).max() == 0, name
        else:
            assert rel_l2(g, j) <= tol, (name, rel_l2(g, j))


def gen_grads_close(gen, jax_grads, tol):
    """Per tensor within ``tol`` relative L2; the biases of the convs under
    ``model``, which an instance norm follows, have a gradient that is 0
    but for rounding: those within 1e-6 of the whole gradient's norm."""
    want = ganimation_from_jax({"params": jax_grads["params"]})
    got = {n: p.grad for n, p in gen.named_parameters()}
    assert want.keys() == got.keys()
    total = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for n, w in want.items():
        g = np.zeros(w.shape, np.float32) if got[n] is None else got[n].numpy()
        if n.startswith("model.") and n.endswith(".bias"):
            assert np.linalg.norm(g) <= 1e-6 * total and np.linalg.norm(w.numpy()) <= 1e-6 * total, n
        elif np.abs(w.numpy()).max() == 0:
            assert np.abs(g).max() == 0, n
        else:
            assert rel_l2(g, w.numpy()) <= tol, (n, rel_l2(g, w.numpy()))


def test_tv_loss_matches_jax():
    m = np.random.RandomState(1).rand(3, 9, 7, 1).astype(np.float32)
    np.testing.assert_allclose(float(TGT.tv_loss(nchw(m))), float(JGT.tv_loss(jnp.asarray(m))),
                               rtol=1e-6)


@pytest.mark.parametrize("quadratic", [False, True], ids=["linear", "quadratic"])
def test_gradient_penalty_and_its_gradient_match_jax(quadratic):
    _, _, disc_apply, d_params, _, critic = models(quadratic)
    rng = np.random.RandomState(3)
    real = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    fake = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    gp_j, grads_j = jax.value_and_grad(lambda p: JGT.wgan_gradient_penalty(
        disc_apply, p, jnp.asarray(real), jnp.asarray(fake), key))(d_params)
    gp = TGT.wgan_gradient_penalty(critic, nchw(real), nchw(fake), torch.from_numpy(jax_alpha(key)))
    gp.backward()
    np.testing.assert_allclose(float(gp.detach()), float(gp_j), rtol=1e-5)
    assert float(gp_j) > 1e-3
    critic_grads_close({n: p.grad for n, p in critic.named_parameters()}, grads_j, 1e-4)


def test_interpolation_weight_comes_from_the_generator():
    a = TGT.interpolation_weight(torch.Generator().manual_seed(3), 4, "cpu")
    torch.manual_seed(0)
    b = TGT.interpolation_weight(torch.Generator().manual_seed(3), 4, "cpu")
    assert a.shape == (4, 1, 1, 1) and torch.equal(a, b) and 0 <= a.min() and a.max() < 1


@pytest.mark.parametrize("objective", ["ganimation", "stargan"])
@pytest.mark.parametrize("quadratic", [False, True], ids=["linear", "quadratic"])
def test_d_and_g_losses_and_gradients_match_jax(objective, quadratic):
    gen_apply, g_vars, disc_apply, d_params, gen, critic = models(quadratic)
    src, src_aus, tar_aus = batch()
    key = jax.random.PRNGKey(1)
    jd, jg = ((JGT.ganimation_d_loss, JGT.ganimation_g_loss) if objective == "ganimation"
              else (JGT.stargan_d_loss, JGT.stargan_g_loss))
    td, tg = ((TGT.ganimation_d_loss, TGT.ganimation_g_loss) if objective == "ganimation"
              else (TGT.stargan_d_loss, TGT.stargan_g_loss))
    j_in = [jnp.asarray(a) for a in (src, src_aus, tar_aus)]
    t_in = [nchw(src), torch.from_numpy(src_aus), torch.from_numpy(tar_aus)]

    (_, jm), grads_j = jax.value_and_grad(
        lambda p: jd(disc_apply, p, gen_apply, g_vars, *j_in, key), has_aux=True)(d_params)
    loss, tm = td(critic, gen, *t_in, torch.from_numpy(jax_alpha(key)))
    loss.backward()
    metrics_close(tm, jm, 1e-5)
    critic_grads_close({n: p.grad for n, p in critic.named_parameters()}, grads_j, 1e-4)
    assert all(p.grad is None for p in gen.parameters())  # the generator ran without a graph

    critic.zero_grad(set_to_none=True)
    (_, jm), grads_j = jax.value_and_grad(
        lambda p: jg(gen_apply, p, disc_apply, d_params, *j_in), has_aux=True)(g_vars)
    loss, tm = tg(gen, critic, *t_in)
    loss.backward()
    metrics_close(tm, jm, 1e-5)
    gen_grads_close(gen, grads_j, 1e-4)


@pytest.mark.parametrize("objective", ["ganimation", "stargan"])
def test_trainer_d_then_g_step_matches_jax(objective, monkeypatch):
    gen_apply, g_vars, disc_apply, d_params, gen, critic = models(quadratic=True)
    src, src_aus, tar_aus = batch(seed=6)
    key = jax.random.PRNGKey(7)
    jstate, jd_step, jg_step = JGT.make_expression_trainer(
        gen_apply, disc_apply, g_vars, jax.tree_util.tree_map(jnp.asarray, d_params),
        model=objective, lr=LR)
    j_in = [jnp.asarray(a) for a in (src, src_aus, tar_aus)]
    jstate, jdm = jd_step(jstate, *j_in, key)
    jd_mu = jstate["d_opt"][0].mu
    jstate, jgm = jg_step(jstate, *j_in)
    jg_mu = jstate["g_opt"][0].mu

    monkeypatch.setattr(TGT, "interpolation_weight",
                        lambda rng, n, device: torch.from_numpy(jax_alpha(key)).to(device))
    state, d_step, g_step = TGT.make_expression_trainer(gen, critic, model=objective, lr=LR,
                                                        device="cpu")
    g0 = [p.detach().clone() for p in gen.parameters()]
    state, dm = d_step(state, nchw(src), src_aus, tar_aus, torch.Generator())
    assert all(torch.equal(a, p) for a, p in zip(g0, gen.parameters()))
    d1 = [p.detach().clone() for p in critic.parameters()]
    d1_grads = [p.grad.clone() for p in critic.parameters()]
    state, gm = g_step(state, nchw(src), src_aus, tar_aus)
    assert all(torch.equal(a, p) for a, p in zip(d1, critic.parameters()))
    assert all(torch.equal(a, p.grad) for a, p in zip(d1_grads, critic.parameters()))
    assert any(not torch.equal(a, p) for a, p in zip(g0, gen.parameters()))
    metrics_close(dm, jdm, 1e-4)
    metrics_close(gm, jgm, 1e-4)

    b1 = 0.5
    critic_grads_close({n: state.d_opt.state[p]["exp_avg"] / (1 - b1)
                        for n, p in critic.named_parameters()},
                       jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1), jd_mu), 1e-4)
    for n, p in gen.named_parameters():
        p.grad = (state.g_opt.state[p]["exp_avg"] / (1 - b1) if p in state.g_opt.state
                  else None)
    gen_grads_close(gen, jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1), jg_mu), 1e-4)
