"""The port's GFPGAN trainer (s2v_torch.train.gfpgan_train) against
s2v_tpu.train.gfpgan_train on the CPU, f32.

- ``roi_crop`` exactly, centres inside, on the border and beyond it (each
  truncated toward zero, then the window clamped); ``gram_mat`` and
  ``component_style_loss`` within rtol 1e-6.
- ``FacialComponentDiscriminator`` at 16^2, 80^2 and 120^2 crops (its
  widths are fixed): the logits, both feature levels and the input
  gradient within 1e-4 of scale (f32, conv summation order), from the same
  random weights. s2v_tpu has no converter for this module, so there is no
  round trip: ``component_disc_from_jax`` gives basicsr's key names, which
  the port module loads strictly.
- ``make_gfpgan_trainer`` against s2v_tpu's own ``make_gfpgan_trainer``,
  which is generic over its applies: the slim GFPGANv1Clean and GPEN
  discriminator at 32^2 and three component discriminators on 16^2 and
  24^2 crops, one g_step then one d_step from the same weights and batch. The
  perceptual and identity hooks are each package's pyramid stand-in and a
  unit channel-mean embedding (VGG16 and IR-SE50 are held on their own in
  test_torch_finetune.py). Metrics within rtol 1e-4; updated parameters
  within lr / 40 on entries whose gradient exceeds 1e-2 of the parameter's
  largest (Adam's first step moves each entry by about lr * sign(g); an
  entry whose gradient is within f32 noise of 0 may move the other way);
  the discriminators unchanged by the g_step and the generator by the
  d_step; ``step`` advances in g_step only.
- The launches of each step kind against ``expected_gfpgan_launches``,
  with a GPEN generator, so that every term of the derivation is non-zero.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2v_torch.ops.kernels  # noqa: F401  (registers the kernel modules)
from s2v_torch.models.gfpgan import GFPGANv1Clean as TGFPGAN
from s2v_torch.models.gpen import Discriminator as TDisc
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.train import gan as TG
from s2v_torch.train import gfpgan_train as TGF
from s2v_torch.train.losses import perceptual_stub as t_stub
from s2v_torch.utils import weights as TW
from s2v_tpu.models.gfpgan import GFPGANv1Clean
from s2v_tpu.models.gpen import Discriminator
from s2v_tpu.train import gfpgan_train as JGF
from s2v_tpu.train.losses import perceptual_stub as j_stub
from slim_zoo import SLIM_GFPGAN_KW
from test_torch_gfpgan import jax_vars
from test_torch_models import close, load, to_nchw
from torch_parity import one_torch_thread, random_variables

SIZE = 32
D_KW = dict(size=SIZE, channel_multiplier=1, narrow=0.25)
ROIS = {"left_eye": 16, "right_eye": 16, "mouth": 24}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_roi_crop_matches_jax_at_and_beyond_the_border():
    rng = np.random.RandomState(1)
    imgs = rng.rand(6, 40, 48, 3).astype(np.float32)
    centers = np.asarray([[24.0, 20.0], [-5.7, 3.2], [47.9, 39.9], [0.5, -0.5],
                          [80.0, -30.0], [7.99, 8.01]], np.float32)
    for size in (8, 16, 40):
        want = np.asarray(JGF.roi_crop(jnp.asarray(imgs), jnp.asarray(centers), size))
        for c in (centers, _t(centers)):
            got = TGF.roi_crop(to_nchw(imgs), c, size).numpy().transpose(0, 2, 3, 1)
            np.testing.assert_array_equal(got, want)


def test_gram_and_component_style_loss_match_jax():
    rng = np.random.RandomState(2)
    f = [rng.randn(2, 8, 8, 4).astype(np.float32), rng.randn(2, 4, 4, 6).astype(np.float32)]
    r = [rng.randn(*x.shape).astype(np.float32) for x in f]
    np.testing.assert_allclose(TGF.gram_mat(to_nchw(f[0])).numpy(),
                               np.asarray(JGF.gram_mat(jnp.asarray(f[0]))), rtol=1e-6,
                               atol=1e-7)
    want = float(JGF.component_style_loss([jnp.asarray(x) for x in f],
                                          [jnp.asarray(x) for x in r]))
    got = TGF.component_style_loss([to_nchw(x) for x in f], [to_nchw(x) for x in r])
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def _fcd(seed):
    model = JGF.FacialComponentDiscriminator()
    v = random_variables(model, (1, 16, 16, 3), seed=seed, equalized=True)
    sd = TW.component_disc_from_jax(v)
    port = TGF.FacialComponentDiscriminator()
    assert set(sd) == set(port.state_dict())
    return model, v, load(port, sd)


@pytest.mark.parametrize("size", [16, 80, 120])
def test_component_discriminator_matches_jax(size):
    rng = np.random.RandomState(size)
    model, v, port = _fcd(seed=3)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    (out, feats), vjp = jax.vjp(lambda x: model.apply(v, x, True), jnp.asarray(x))
    w = rng.randn(*out.shape).astype(np.float32)
    (want_dx,) = vjp((jnp.asarray(w), [jnp.zeros_like(f) for f in feats]))
    xt = to_nchw(x).requires_grad_(True)
    got, got_feats = port(xt, return_feats=True)
    assert port(xt)[1] is None and got.shape == (2, 1, size // 4, size // 4)
    close(got.detach().numpy().transpose(0, 2, 3, 1), out)
    for g, f in zip(got_feats, feats):
        close(g.detach().numpy().transpose(0, 2, 3, 1), f)
    (got * to_nchw(w)).sum().backward()
    close(xt.grad.numpy().transpose(0, 2, 3, 1), want_dx)


def _embed_jax(x):  # NHWC -> a unit vector per image from its channel means
    m = x.mean(axis=(1, 2))
    return m / jnp.linalg.norm(m, axis=-1, keepdims=True)


def _embed_port(x):
    m = x.mean(dim=(2, 3))
    return m / m.norm(dim=-1, keepdim=True)


def _batch(seed, n=2, size=SIZE):
    rng = np.random.RandomState(seed)
    batch = {k: rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for k in ("lq", "gt")}
    for name in ROIS:  # one centre near a border, one inside
        batch[f"loc_{name}"] = np.asarray([[3.5, size - 2.0], [size / 2 + 5, size / 2 - 7]],
                                          np.float32)
    return batch


def test_trainer_steps_match_jax():
    gen, disc = GFPGANv1Clean(out_size=SIZE, **SLIM_GFPGAN_KW), Discriminator(**D_KW)
    gv = jax_vars(SIZE, SLIM_GFPGAN_KW, seed=4)
    dv = random_variables(disc, (1, SIZE, SIZE, 3), seed=5, equalized=True)
    fcd = JGF.FacialComponentDiscriminator()
    cv = {name: random_variables(fcd, (1, 16, 16, 3), seed=6 + i, equalized=True)
          for i, name in enumerate(ROIS)}
    batch = _batch(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jstate, jg_step, jd_step = JGF.make_gfpgan_trainer(
        lambda p, x: gen.apply({"params": p}, x), lambda p, x: disc.apply({"params": p}, x),
        lambda p, x, rf: fcd.apply(p, x, rf), gv["params"], dv["params"], cv,
        vgg_loss_fn=j_stub, id_embed_fn=_embed_jax, roi_sizes=ROIS)
    g_port = load(TGFPGAN(out_size=SIZE, **SLIM_GFPGAN_KW), TW.gfpgan_clean_from_jax(gv))
    d_port = load(TDisc(**D_KW), TW.gpen_disc_from_jax(dv))
    comps = {n: load(TGF.FacialComponentDiscriminator(), TW.component_disc_from_jax(cv[n]))
             for n in ROIS}
    state, g_step, d_step = TGF.make_gfpgan_trainer(
        g_port, d_port, comps, device="cpu", vgg_loss_fn=t_stub, id_embed_fn=_embed_port,
        roi_sizes=ROIS)

    def flat(module):
        return {k: p.detach().numpy().copy() for k, p in module.named_parameters()}

    def check_metrics(got, want):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)

    def check_updated(module, want_sd, lr=2e-3):
        for name, p in module.named_parameters():
            if p.grad is None:  # never on the path (GFPGAN's toRGB heads, style MLP)
                np.testing.assert_array_equal(p.detach().numpy(), want_sd[name].numpy())
                continue
            g = np.abs(p.grad.numpy())
            keep = g > 1e-2 * g.max()
            np.testing.assert_allclose(p.detach().numpy()[keep], want_sd[name].numpy()[keep],
                                       rtol=0, atol=lr / 40, err_msg=name)

    def tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    d_before, c_before = flat(state.d), {n: flat(c) for n, c in state.comps.items()}
    jstate, jm = jg_step(jstate, jbatch)
    state, m = g_step(state, batch)
    check_metrics(m, jm)
    check_updated(state.g, TW.gfpgan_clean_from_jax({"params": tree(jstate["g"])}))
    assert all(np.array_equal(v, d_before[k]) for k, v in flat(state.d).items())
    assert all(np.array_equal(v, c_before[n][k])
               for n, c in state.comps.items() for k, v in flat(c).items())
    assert state.step == int(jstate["step"]) == 1

    # the d_step from the JAX generator of the moment (the Adam caveat above
    # leaves a few of the port's entries elsewhere)
    state.g.load_state_dict(TW.gfpgan_clean_from_jax({"params": tree(jstate["g"])}))
    g_before = flat(state.g)
    jstate, jm = jd_step(jstate, jbatch)
    state, m = d_step(state, batch)
    check_metrics(m, jm)
    check_updated(state.d, TW.gpen_disc_from_jax({"params": tree(jstate["d"])}))
    for n, c in state.comps.items():
        check_updated(c, TW.component_disc_from_jax(tree(jstate["comp"][n])))
    assert all(np.array_equal(v, g_before[k]) for k, v in flat(state.g).items())
    assert state.step == int(jstate["step"]) == 1


def test_trainer_launch_counts_follow_the_layers(monkeypatch):
    """Each step kind calls the kernels' versions as often as
    expected_gfpgan_launches derives from the modules' K1 and K3 sites
    (counted on the plain versions, which a CUDA run replaces one for one
    by launches). The generator is a slim GPEN, so its sites count too."""
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
    g = TGPEN(size=32, style_dim=32, n_mlp=2, channel_multiplier=1, narrow=0.125)
    d = TDisc(size=32, channel_multiplier=1, narrow=0.125)
    comps = {n: TGF.FacialComponentDiscriminator() for n in ROIS}
    want = TG.expected_gfpgan_launches(g, d, comps)
    assert TG.kernel_sites(comps["mouth"]) == (5, 2)
    assert all(v > 0 for kind in want.values() for v in kind.values())
    state, g_step, d_step = TGF.make_gfpgan_trainer(g, d, comps, device="cpu", roi_sizes=ROIS)
    batch = _batch(8, size=32)
    for kind, step in (("g", g_step), ("d", d_step), ("g", g_step)):
        for k in counts:
            counts[k] = 0
        state, _ = step(state, batch)
        assert counts == want[kind], kind


def test_trainer_refuses_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TGF.make_gfpgan_trainer(TGPEN(size=32, style_dim=32, n_mlp=2, channel_multiplier=1,
                                      narrow=0.125),
                                TDisc(size=32, channel_multiplier=1, narrow=0.125),
                                {"mouth": TGF.FacialComponentDiscriminator()})
