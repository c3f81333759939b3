"""The port's face-verification evaluation (s2v_torch.train.verification)
against the JAX package's on the CPU.

- ``calculate_roc``, ``evaluate``, the IJB-C template functions and
  ``tar_at_far`` on the same embeddings: equal (the same numpy code).
- ``extract_embeddings`` through a slim IResNet ((1, 1, 1, 1), 32-d,
  weights from ``iresnet_from_jax``, eval mode) on 6 faces in batches of
  4 (the last one padded), with the flip: within 1e-4 of JAX's (measured
  9.5e-7; both L2-normalised).
- ``VerificationCallback`` runs only on positive multiples of ``frequent``
  and keeps the best accuracy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.models import iresnet as TI
from s2v_torch.train import verification as TV
from s2v_torch.utils import weights as TW
from s2v_tpu.models import iresnet as JI
from s2v_tpu.train import verification as JV
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _pairs(n=120, e=16, seed=1):
    rng = np.random.RandomState(seed)
    same = rng.rand(n) > 0.5
    base = rng.randn(n, e)
    emb1 = base + rng.randn(n, e) * 0.3
    emb2 = np.where(same[:, None], base + rng.randn(n, e) * 0.3, rng.randn(n, e))
    emb1 /= np.linalg.norm(emb1, axis=1, keepdims=True)
    emb2 /= np.linalg.norm(emb2, axis=1, keepdims=True)
    return emb1, emb2, same


def test_roc_and_evaluate_match_jax():
    emb1, emb2, same = _pairs()
    thresholds = np.arange(0, 4, 0.01)
    for got, want in zip(TV.calculate_roc(thresholds, emb1, emb2, same, nrof_folds=7),
                         JV.calculate_roc(thresholds, emb1, emb2, same, nrof_folds=7)):
        np.testing.assert_array_equal(got, want)
    emb = np.stack([emb1, emb2], 1).reshape(-1, emb1.shape[1])
    assert TV.evaluate(emb, same) == JV.evaluate(emb, same)
    assert TV.calculate_accuracy(0.9, np.sum((emb1 - emb2) ** 2, 1), same) == \
        JV.calculate_accuracy(0.9, np.sum((emb1 - emb2) ** 2, 1), same)


def test_templates_and_tar_at_far_match_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(40, 8)
    templates = rng.randint(3, 12, 40)
    medias = rng.randint(0, 6, 40)
    got_t, got_u = TV.image2template_feature(feats, templates, medias)
    want_t, want_u = JV.image2template_feature(feats, templates, medias)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_u, want_u)
    p1, p2 = rng.choice(got_u, 30), rng.choice(got_u, 30)
    scores = TV.template_verification_scores(got_t, got_u, p1, p2)
    np.testing.assert_array_equal(scores, JV.template_verification_scores(want_t, want_u,
                                                                          p1, p2))
    big = np.concatenate([rng.randn(1000) + 3, rng.randn(1000)])
    labels = np.arange(2000) < 1000
    assert TV.tar_at_far(big, labels) == JV.tar_at_far(big, labels)


@pytest.fixture(scope="module")
def iresnet():
    jmodel = JI.IResNet(layers=(1, 1, 1, 1), num_features=32)
    v = random_variables(jmodel, (2, 112, 112, 3), seed=3)
    v["batch_stats"]["features_var"] = np.abs(v["batch_stats"]["features_var"]) + 0.5
    port = TI.IResNet((1, 1, 1, 1), 32)
    port.load_state_dict(TW.iresnet_from_jax(v), strict=True)
    images = np.random.RandomState(4).uniform(-1, 1, (6, 112, 112, 3)).astype(np.float32)
    return jmodel, v, port.eval(), images


def test_extract_embeddings_matches_jax(iresnet):
    jmodel, v, port, images = iresnet
    want = JV.extract_embeddings(lambda x: jmodel.apply(v, x), images, batch=4)
    got = TV.extract_embeddings(port, images, batch=4, device="cpu")
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the flip is the width axis: without it the embeddings change
    assert np.abs(TV.extract_embeddings(port, images, batch=4, flip=False, device="cpu")
                  - got).max() > 1e-3


def test_verification_callback_fires_on_multiples_of_frequent():
    rng = np.random.RandomState(5)
    images = rng.rand(40, 8, 8, 3).astype(np.float32)
    issame = rng.rand(20) > 0.5
    calls = []

    def embed_fn(x):  # channel means of [B, 3, H, W], as a tensor
        calls.append(x.shape)
        return x.mean((2, 3))

    cb = TV.VerificationCallback(images, issame, frequent=3, device="cpu")
    fired = {s: cb(s, embed_fn) for s in range(8)}
    assert [s for s, r in fired.items() if r is not None] == [3, 6]
    assert len(calls) == 4 and calls[0] == (64, 3, 8, 8)  # two runs, a flip each
    want = JV.evaluate(JV.extract_embeddings(lambda x: jnp.mean(x, axis=(1, 2)), images),
                       issame)
    assert fired[3]["val_acc"] == pytest.approx(want[0], abs=1e-12)
    assert fired[6]["best_acc"] == max(fired[3]["val_acc"], fired[6]["val_acc"])
