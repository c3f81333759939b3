"""The port's quality metrics (s2v_torch.pipeline.metrics) and LPIPS
(s2v_torch.models.vgg) against the JAX package's on the CPU, f32.

- ``psnr`` and ``ssim`` on the same 0..255 images (NCHW here, NHWC there):
  within 1e-5 relative.
- ``SyncNet`` at its fixed (full) widths, batch 2, random JAX variables
  with BatchNorm statistics away from 0 and 1 (means +-0.1, variances in
  [0.5, 1.5]) through ``syncnet_from_jax`` (strict): both embeddings within
  1e-4 absolute (measured 2.8e-7; JAX's own test against a torch twin holds
  2e-3). The state_dict has wav2lip SyncNet_color's keys and goes back
  through s2v_tpu's ``convert_syncnet`` to the flax tree.
  ``lse_metrics`` gives s2v_tpu's values.
- ``lpips_distance`` (VGG16 at full width to conv5_3, random lin heads) on
  two 64^2 pairs: within 1e-5 relative. ``lpips_lin`` reads a random lin
  file as ``convert_lpips_lin`` does. ``vgg16_features`` refuses, at LPIPS
  depth, a file that lacks ``features.28``, which the perceptual loss's
  depth does not need.
"""

import numpy as np
import pytest
import torch

import jax

from s2v_torch.models import vgg as TV
from s2v_torch.pipeline import metrics as TM
from s2v_torch.utils import weights as TW
from s2v_tpu.models import vgg as JV
from s2v_tpu.pipeline import metrics as JM
from s2v_tpu.utils import weights as JW
from test_torch_models import assert_same_tree, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_psnr_and_ssim_match_jax():
    rng = np.random.RandomState(1)
    a = (rng.rand(2, 40, 48, 3) * 255).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape) * 12, 0, 255).astype(np.float32)
    for port, jax_fn in ((TM.psnr, JM.psnr), (TM.ssim, JM.ssim)):
        want = float(jax_fn(a, b))
        got = float(port(to_nchw(a), to_nchw(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=port.__name__)
    assert float(TM.ssim(to_nchw(a), to_nchw(a))) == pytest.approx(1.0, rel=1e-5)


@pytest.fixture(scope="module")
def syncnet():
    v = random_variables(JM.SyncNet(), (1, 48, 96, 15), (1, 80, 16, 1), seed=2)
    rng = np.random.RandomState(3)
    face = rng.rand(2, 48, 96, 15).astype(np.float32)
    mel = rng.randn(2, 80, 16, 1).astype(np.float32)
    want = [np.asarray(e) for e in jax.jit(JM.SyncNet().apply)(v, face, mel)]
    return v, face, mel, want


def test_syncnet_matches_jax(syncnet):
    v, face, mel, want = syncnet
    port = load(TM.SyncNet(), TW.syncnet_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(face), to_nchw(mel))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 512)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def test_syncnet_state_dict_is_wav2lips(syncnet):
    v = syncnet[0]
    sd = numpy_sd(load(TM.SyncNet(), TW.syncnet_from_jax(v)).state_dict())
    want = {f"{enc}.{i}.conv_block.{part}"
            for enc, n in (("face_encoder", 15), ("audio_encoder", 14)) for i in range(n)
            for part in ("0.weight", "0.bias", "1.weight", "1.bias", "1.running_mean",
                         "1.running_var", "1.num_batches_tracked")}
    assert set(sd) == want
    assert_same_tree(JW.convert_syncnet(sd), v)


def test_lse_metrics_match_jax():
    rng = np.random.RandomState(4)
    audio = rng.randn(40, 512).astype(np.float32)
    audio /= np.linalg.norm(audio, axis=1, keepdims=True)
    face = audio + rng.randn(40, 512).astype(np.float32) * 0.05
    face /= np.linalg.norm(face, axis=1, keepdims=True)
    for f in (face, np.roll(face, 5, axis=0)):
        assert TM.lse_metrics(f, audio) == JM.lse_metrics(f, audio)


LIN_WIDTHS = (64, 128, 256, 512, 512)


@pytest.fixture(scope="module")
def lpips():
    model = JV.VGG16Features(block_ends=JV.LPIPS_ENDS)
    v = random_variables(model, (1, 64, 64, 3), seed=5)
    rng = np.random.RandomState(6)
    lin = {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
           for i, c in enumerate(LIN_WIDTHS)}
    return v, lin


def test_lpips_distance_matches_jax(lpips):
    v, lin = lpips
    rng = np.random.RandomState(7)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.2, -1, 1)
    want = np.asarray(JV.lpips_distance(v, JV.convert_lpips_lin(lin), a, b))
    port = TV.vgg16_features(TW.vgg16_from_jax(v), TV.LPIPS_ENDS).eval()
    with torch.no_grad():
        got = TV.lpips_distance(port, TV.lpips_lin(lin), to_nchw(a), to_nchw(b)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_lin_reads_convert_lpips_lins_layout(lpips):
    lin = {k: torch.from_numpy(w) for k, w in lpips[1].items()}
    for got, want in zip(TV.lpips_lin(lin), JV.convert_lpips_lin(lpips[1]), strict=True):
        np.testing.assert_array_equal(got.numpy(), want)


def test_vgg16_features_needs_conv5_3_for_lpips(lpips):
    sd = {k: t for k, t in TW.vgg16_from_jax(lpips[0]).items()
          if not k.startswith("features.28.")}
    with pytest.raises(KeyError, match="features.28.weight"):
        TV.vgg16_features(sd, TV.LPIPS_ENDS)
    assert len(TV.vgg16_features(sd).features) == TV.BLOCK_ENDS[-1]
