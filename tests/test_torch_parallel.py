"""The port's multi-device surface (s2v_torch.parallel) against the JAX
package's on the CPU (tests/test_parallel.py and tests/test_zero.py are the
JAX side's own tests).

- ``make_mesh`` shapes over a list of CPU devices against JAX's over its
  devices, and the frame shard / gather round trip, each slice JAX's shard
  on that device (exact);
- PartialFC at model axis 2 on two gloo ranks (``torch_dist_ranks``): the
  loss within rtol 2e-4 of JAX's ``make_sharded_classifier`` on its
  8-virtual-device CPU mesh at model axis 2, and the feature and weight
  gradients within rtol 1e-3, atol 1e-4 of its ``grad_fn`` (f32; the
  tolerances of the JAX test); ``sample_rate`` 1.0 within 2e-4 of the
  unsampled loss; at 0.25, gradient on at most ``num_sample`` rows per
  shard and on every positive row, and a loss no larger than the full one;
- ``sharded_coeff_windows`` (the halo-exchange and the all-gather paths)
  and ``windowed_map`` equal to ``gather_windows`` of the whole clip, which
  equals JAX's (exact), and ``smooth_boxes`` of integer boxes equal to
  JAX's truncating one (exact);
- ``hosts`` over the group, and ZeRO-1: two SGD + momentum steps with the
  momentum sharded over the data group equal to replicated state, with less
  state held per rank, both replicas bit-equal;
- ``replicas_agree`` sees a 1e-6 difference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from s2v_torch.parallel import halo as TH
from s2v_torch.parallel import mesh as TM
from s2v_tpu.parallel import halo as JH
from s2v_tpu.parallel.mesh import MODEL_AXIS, make_mesh, shard_frames
from s2v_tpu.parallel.partial_fc import make_sharded_classifier, partial_fc_loss
import torch_dist_ranks

RNG = np.random.RandomState(3)


def test_make_mesh_shapes():
    mesh = TM.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == dict(make_mesh().shape) == {"data": 8, "model": 1}
    assert len(mesh.data_devices) == 8
    mesh2 = TM.make_mesh(data_parallel=2, model_parallel=4, devices=["cpu"] * 8)
    assert mesh2.shape == dict(make_mesh(data_parallel=2, model_parallel=4).shape)
    assert mesh2.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        TM.make_mesh(3, 2, devices=["cpu"] * 8)


def test_frame_shard_gather_round_trip():
    mesh = TM.make_mesh(devices=["cpu"] * 4)
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    parts = TM.shard_frames(x, mesh)
    # the slices JAX's frame sharding puts on each device of a 4-device mesh
    jx = shard_frames(jnp.asarray(x.numpy()), make_mesh(devices=jax.devices()[:4]))
    want = sorted((s.index[0].start or 0, np.asarray(s.data)) for s in jx.addressable_shards)
    for p, (_, w) in zip(parts, want):
        np.testing.assert_array_equal(p.numpy(), w)
    assert torch.equal(TM.gather_frames(parts, mesh), x)
    # a chunk that does not divide the data axis stays whole
    assert len(TM.shard_frames_if_divisible(x[:6], mesh)) == 1
    got = TM.map_frames(lambda a, b: (a * 2, b), x, x + 1, mesh=mesh)
    assert torch.equal(got[0], x * 2) and torch.equal(got[1], x + 1)
    padded, n = TM.pad_to_multiple(x[:6], 4)
    assert n == 6 and padded.shape[0] == 8 and torch.equal(padded[6:], x[5:6].expand(2, 3))
    # a replica on another device is a copy there; the module serves its own
    lin = torch.nn.Linear(3, 2)
    assert mesh.replica(lin, "cpu") is lin
    meta = mesh.replica(lin, "meta")
    assert meta is not lin and meta.weight.device.type == "meta"
    assert mesh.replica(lin, "meta") is meta


def _reference_softmax_loss(features, labels, weight, margin_kind, s=64.0, m=0.5):
    wn = weight / np.linalg.norm(weight, axis=1, keepdims=True)
    logits = features @ wn.T
    onehot = np.eye(weight.shape[0])[labels]
    if margin_kind == "arcface":
        cos = np.clip(logits, -1 + 1e-7, 1 - 1e-7)
        logits = s * np.where(onehot > 0, np.cos(np.arccos(cos) + m), cos)
    elif margin_kind == "cosface":
        logits = s * (logits - onehot * m)
    else:
        logits = logits * s
    logits = logits - logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return -np.mean(logp[np.arange(len(labels)), labels])


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    """One gloo group of two ranks runs every multi-process check; the JAX
    references are computed here."""
    b, e, c = 8, 16, 32
    feats = RNG.randn(b, e).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    s_feats = RNG.randn(8, 16).astype(np.float32)
    s_feats /= np.linalg.norm(s_feats, axis=1, keepdims=True)
    refs = dict(feats=feats, labels=RNG.randint(0, c, size=b).astype(np.int64),
                weight=RNG.randn(c, e).astype(np.float32),
                s_feats=s_feats, s_labels=RNG.randint(0, 128, size=8).astype(np.int64),
                s_weight=RNG.randn(128, 16).astype(np.float32),
                coeffs=RNG.randn(32, 73).astype(np.float32),
                boxes=(RNG.rand(11, 4) * 100).astype(np.int32),
                zx=RNG.randn(32, 64).astype(np.float32), zy=RNG.randn(32, 16).astype(np.float32),
                zw=RNG.randn(64, 16).astype(np.float32), zb=RNG.randn(16).astype(np.float32))
    jax_refs = {}
    mesh = make_mesh(data_parallel=1, model_parallel=2, devices=jax.devices()[:2])
    w_sh = jax.device_put(jnp.asarray(refs["weight"]), NamedSharding(mesh, P(MODEL_AXIS, None)))
    for margin in ("none", "cosface", "arcface"):
        loss_fn, grad_fn = make_sharded_classifier(mesh, margin_kind=margin)
        args = (jnp.asarray(feats), jnp.asarray(refs["labels"].astype(np.int32)), w_sh)
        gf, gw = grad_fn(*args)
        jax_refs[margin] = dict(loss=float(loss_fn(*args)), gf=np.asarray(gf), gw=np.asarray(gw))

    def sampled(rate):
        f = shard_map(lambda ft, lb, w: partial_fc_loss(
            ft, lb, w, margin_kind="cosface", sample_rate=rate, rng=jax.random.PRNGKey(7)),
            mesh=mesh, in_specs=(P(), P(), P(MODEL_AXIS, None)), out_specs=P())
        w = jax.device_put(jnp.asarray(refs["s_weight"]), NamedSharding(mesh, P(MODEL_AXIS, None)))
        return float(jax.jit(f)(jnp.asarray(s_feats), jnp.asarray(refs["s_labels"], jnp.int32), w))

    jax_refs["rate1"], jax_refs["rate025"] = sampled(1.0), sampled(0.25)
    path = tmp_path_factory.mktemp("parallel_group")
    return refs, jax_refs, torch_dist_ranks.spawn(torch_dist_ranks.parallel_ranks, 2, path, refs)


@pytest.mark.parametrize("margin", ["none", "cosface", "arcface"])
def test_partial_fc_matches_jax_at_model_axis_2(group_results, margin):
    refs, jax_refs, ranks = group_results
    want = jax_refs[margin]
    np.testing.assert_allclose(
        want["loss"], _reference_softmax_loss(refs["feats"], refs["labels"], refs["weight"],
                                              margin), rtol=2e-4, atol=2e-4)
    for r in ranks:
        np.testing.assert_allclose(r[margin]["loss"], want["loss"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r[margin]["gf"], want["gf"], rtol=1e-3, atol=1e-4)
    gw = np.concatenate([r[margin]["gw"] for r in ranks])
    np.testing.assert_allclose(gw, want["gw"], rtol=1e-3, atol=1e-4)


def test_partial_fc_sampling_invariants(group_results):
    refs, jax_refs, ranks = group_results
    full = _reference_softmax_loss(refs["s_feats"], refs["s_labels"], refs["s_weight"],
                                   "cosface")
    for r in ranks:
        np.testing.assert_allclose(r["rate1"], full, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["rate1"], jax_refs["rate1"], rtol=2e-4, atol=2e-4)
        # a subset of the negatives in the denominator: no larger, still positive
        assert 0.0 < r["sampled"]["loss"] <= full + 1e-3
    assert ranks[0]["sampled"]["loss"] == ranks[1]["sampled"]["loss"]
    assert 0.0 < jax_refs["rate025"] <= full + 1e-3
    gw = np.concatenate([r["sampled"]["gw"] for r in ranks])
    rows = np.abs(gw).sum(axis=1) > 0
    for shard in rows.reshape(2, 64):
        assert shard.sum() <= 16  # int(0.25 * 64) per shard
    assert rows[np.unique(refs["s_labels"])].all()


def test_windows_of_a_split_clip(group_results):
    refs, _, ranks = group_results
    for name, n in (("halo", 32), ("gather", 8)):
        want = np.asarray(JH.gather_windows(jnp.asarray(refs["coeffs"][:n]), 26))
        got = np.concatenate([r[f"windows_{name}"] for r in ranks])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TH.gather_windows(torch.from_numpy(refs["coeffs"][:n]), 26).numpy(), want)
    x = refs["coeffs"][:32]
    padded = np.concatenate([x[:1], x[:1], x, x[-1:], x[-1:]])
    want = np.stack([padded[i:i + 5].mean(0) for i in range(32)])
    np.testing.assert_allclose(np.concatenate([r["box_mean"] for r in ranks]), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TH.smooth_boxes(refs["boxes"], 5),
                                  np.asarray(JH.smooth_boxes(jnp.asarray(refs["boxes"]), 5,
                                                             truncate=True)))


def test_hosts_zero_and_replica_checks(group_results):
    _, _, ranks = group_results
    assert ranks[0]["hosts"] == (0, 2, True, [0, 2, 4, 6], 0)
    assert ranks[1]["hosts"] == (1, 2, False, [1, 3, 5], None)
    for r in ranks:
        (w_repl, n_repl), (w_zero, n_zero) = r["zero"]["repl"], r["zero"]["zero"]
        np.testing.assert_allclose(w_zero, w_repl, rtol=2e-5, atol=2e-6)
        assert 0 < n_zero < n_repl  # each rank holds a share of the momentum
        assert r["zero_agree_repl"] and r["zero_agree_zero"]
        assert r["agree"] == (True, False)
    assert sum(r["zero"]["zero"][1] for r in ranks) == ranks[0]["zero"]["repl"][1]
