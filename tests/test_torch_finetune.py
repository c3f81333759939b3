"""The port's ENet fine-tuning (s2v_torch.train.{losses,finetune,
finetune_enet,data}, s2v_torch.utils.{checkpoint,diagnostics}) against
s2v_tpu's on the CPU, f32.

- The losses (``l1_loss``, ``laplacian_pyramid``, ``perceptual_stub``,
  ``identity_loss``) within rtol 1e-6.
- ``style_conv_mask`` (one step against the JAX step is
  test_torch_finetune_step.py's).
- ``build_enet_batches`` against s2v_tpu's on one clip and the same
  pipeline inputs (S3FD at full width, its face class raised by 2; the
  stabilised frames' landmarks from ``fixed_landmarks`` on both sides): the
  same integer boxes, batches within 1/255.
- ``TrainCheckpointer``: save, retention, restore bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import s3fd as t_s3fd
from s2v_torch.models.enet import ENet as TENet
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.train import data as TD
from s2v_torch.train import finetune as TF
from s2v_torch.train import finetune_enet as TFE
from s2v_torch.train import losses as TL
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_torch.utils.checkpoint import TrainCheckpointer
from s2v_tpu.audio import melspectrogram
from s2v_tpu.models.s3fd import S3FD
from s2v_tpu.pipeline import inference as j_inf
from s2v_tpu.train import data as JD
from s2v_tpu.train import losses as JL
from s2v_tpu.utils.config import PipelineConfig, override
from test_torch_models import ENET_KW, load, to_nchw
from torch_parity import fixed_landmarks, one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


@pytest.mark.parametrize("name", ["l1_loss", "perceptual_stub", "laplacian_pyramid",
                                  "identity_loss"])
def test_losses_match_jax(name):
    rng = np.random.RandomState(1)
    a, b = (rng.rand(2, 32, 48, 3).astype(np.float32) for _ in range(2))
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), to_nchw(a), to_nchw(b)
    if name == "laplacian_pyramid":
        for got, want in zip(TL.laplacian_pyramid(ta, 3), JL.laplacian_pyramid(ja, 3),
                             strict=True):
            np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6,
                                       atol=1e-6)
        return
    if name == "identity_loss":  # an embedding of the top-left 4x4 pixels
        w = rng.randn(48, 5).astype(np.float32)
        want = JL.identity_loss(ja, jb, lambda x: x[:, :4, :4].reshape(2, -1) @ w)
        got = TL.identity_loss(ta, tb, lambda x: x[:, :, :4, :4].permute(0, 2, 3, 1)
                               .reshape(2, -1) @ torch.from_numpy(w))
        assert float(TL.identity_loss(ta, tb)) == float(JL.identity_loss(ja, jb)) == 0.0
    else:
        want, got = getattr(JL, name)(ja, jb), getattr(TL, name)(ta, tb)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_make_train_step_matches_jax():
    """The generic step (L1 + the pyramid stand-in, Adam on every
    parameter) on a 3x3 conv: metrics within rtol 1e-6 of s2v_tpu's
    ``make_train_step`` and the updated weights within lr / 40 on entries
    whose gradient exceeds 1e-2 of the largest."""
    import optax

    from s2v_tpu.train.finetune import TrainState as JState
    from s2v_tpu.train.finetune import init_state, make_train_step

    rng = np.random.RandomState(6)
    w = (rng.randn(3, 3, 3, 3) / 5).astype(np.float32)  # HWIO
    x, target = (rng.rand(2, 16, 16, 3).astype(np.float32) for _ in range(2))

    def apply_jax(params, batch):
        return jax.lax.conv_general_dilated(batch["x"], params["w"], (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jstep = make_train_step(apply_jax, optax.adam(1e-3))
    jstate, jm = jstep(init_state({"w": jnp.asarray(w)}, optax.adam(1e-3)),
                       {"x": jnp.asarray(x), "target": jnp.asarray(target)})
    assert isinstance(jstate, JState)
    conv = torch.nn.Conv2d(3, 3, 3, padding=1, bias=False)
    conv.weight.data = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    state = TF.init_state(conv, TF.make_optimizer(1e-3, conv))
    step = TF.make_train_step(lambda m, b: m(b["x"]))
    state, m = step(state, {"x": to_nchw(x), "target": to_nchw(target)})
    assert state.step == int(jstate.step) == 1 and set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    g = conv.weight.grad.abs()
    keep = (g > 1e-2 * g.max()).numpy()
    want = np.asarray(jstate.params["w"]).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(conv.weight.detach().numpy()[keep], want[keep], rtol=0,
                               atol=1e-3 / 40)


def test_style_conv_mask_leaves_to_rgb_frozen():
    mask = TF.style_conv_mask(TENet(**ENET_KW))
    assert any(mask.values())
    assert all(v == k.startswith("style_convs.") for k, v in mask.items())


N, H, W = 4, 128, 128


def test_build_enet_batches_matches_jax():
    s3fd = random_variables(S3FD(), (1, 128, 128, 3), seed=50)
    s3fd["params"]["conv3_3_norm_mbox_conf"]["bias"][3] += 2.0
    rng = np.random.RandomState(41)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255.0 / W, yy * 255.0 / H, (xx + yy) * 127.0 / (H + W)], -1)
    frames = np.clip(base[None] + rng.randn(N, H, W, 3) * 30, 0, 255).astype(np.uint8)
    stab = (rng.rand(N, 256, 256, 3) * 255).astype(np.uint8)
    lms = fixed_landmarks(N, 256, 256, seed=42)
    t = np.arange(5600) / 16000.0
    jmel = melspectrogram(jnp.asarray(np.sin(2 * np.pi * 200 * t).astype(np.float32) * 0.4))
    coords = (16, 112, 16, 112)

    jpipe = j_inf.LipSyncPipeline(override(PipelineConfig(), {"model.dtype": "float32"}),
                                  j_inf.PipelineModels(s3fd=s3fd))
    tpipe = t_inf.LipSyncPipeline(
        t_cfg.PipelineConfig(model=t_cfg.ModelConfig(dtype="float32")),
        t_inf.PipelineModels(s3fd=load(t_s3fd.S3FD(), TW.s3fd_from_jax(s3fd))), device="cpu")
    raw = {}
    for pipe in (jpipe, tpipe):  # the stabilised frames' landmarks, injected alike
        pipe.extract_landmarks = lambda f, **kw: lms[:len(f)]
        detect = pipe.detect_boxes

        def spy(f, _detect=detect, _name=type(pipe).__module__, **kw):
            raw[_name] = np.asarray(_detect(f, **kw))
            return raw[_name]

        pipe.detect_boxes = spy
    want = JD.build_enet_batches(jpipe, stab, jmel, frames, coords, 25.0, batch_size=3)
    got = TD.build_enet_batches(tpipe, stab, torch.from_numpy(np.array(jmel)), frames,
                                coords, 25.0, batch_size=3)
    # floor() makes the boxes integers: the raw boxes (s2v_tpu's unclipped)
    # must agree, and lie farther from an integer than ten times their
    # difference, so that both floors agree
    j_raw, t_raw = np.maximum(raw[j_inf.__name__], 0), raw[t_inf.__name__]
    diff = np.abs(t_raw - j_raw)
    assert diff.max() <= 1e-3, diff.max()
    frac = np.abs(t_raw - np.round(t_raw))
    assert (frac[t_raw > 0] > 10 * diff.max()).all(), (t_raw, diff.max())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"mel", "face", "ref", "target"}
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == np.float32, k
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0,
                                       atol=1e-5 if k == "mel" else 1.0 / 255, err_msg=k)
    assert got[0]["target"].std() > 0.05 and got[0]["ref"].std() > 0.05


def test_train_checkpointer_saves_keeps_and_restores(tmp_path):
    torch.manual_seed(0)
    enet = TENet(**ENET_KW)
    state = TF.init_state(enet, TF.make_optimizer(1e-3, enet, TF.style_conv_mask))
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in (1, 2, 3):
        for p in enet.style_convs.parameters():
            p.grad = torch.randn_like(p)
        state.opt.step()
        state.step = step
        ckpt.save(step, state)
    ckpt.wait()
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    trained = {k: t.clone() for k, t in enet.state_dict().items()}
    torch.manual_seed(0)
    fresh = TENet(**ENET_KW)
    restored = ckpt.restore(TF.init_state(fresh, TF.make_optimizer(1e-3, fresh,
                                                                   TF.style_conv_mask)))
    assert restored.step == 3
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, trained[k]), k
    got, want = restored.opt.state_dict()["state"], state.opt.state_dict()["state"]
    assert got.keys() == want.keys()
    for i in want:
        for k in want[i]:
            assert torch.equal(got[i][k], want[i][k])


def test_finetune_step_refuses_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TFE.make_enet_finetune_step(TENet(**ENET_KW), t_cfg.TrainConfig())
