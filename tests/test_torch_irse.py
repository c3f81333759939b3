"""The port's IR-SE50 identity backbone (s2v_torch.models.irse) against
s2v_tpu's on the CPU, f32, from the same random weights, at batch 1 (its
widths are fixed): ``ir_se`` and ``ir`` embeddings within 1e-4 (unit
vectors) and the round trip through s2v_tpu's ``convert_irse``;
``id_loss_feats`` at 256^2 and 512^2; ``id_loss`` and its gradient with
respect to ``y_hat`` (relative L2 error 1e-3, as test_torch_vgg.py's
``assert_grad_close`` says).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import irse as TI
from s2v_torch.utils import weights as TW
from s2v_tpu.models import irse as JI
from s2v_tpu.utils.weights import convert_irse
from test_torch_models import assert_same_tree, load, numpy_sd, to_nchw
from test_torch_vgg import assert_grad_close, nhwc
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def irse_variables(mode, seed=12):
    """Random BackboneIRSE variables at working scales; the head's dense
    layer, BatchNorm1d scale and variance take their own (random_variables
    knows them by other names)."""
    v = random_variables(JI.BackboneIRSE(mode=mode), (1, 112, 112, 3), seed=seed)
    rng = np.random.RandomState(seed + 1)
    p, s = v["params"], v["batch_stats"]
    p["linear_weight"] = (rng.randn(*p["linear_weight"].shape)
                          / np.sqrt(p["linear_weight"].shape[0])).astype(np.float32)
    p["head_weight"] = (1.0 + 0.1 * rng.randn(512)).astype(np.float32)
    s["head_var"] = rng.uniform(0.5, 1.5, 512).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def irse():
    return {mode: irse_variables(mode) for mode in ("ir_se", "ir")}


def _port(mode, v):
    return load(TI.BackboneIRSE(mode=mode), TW.irse_from_jax(v)).requires_grad_(False)


@pytest.mark.parametrize("mode", ["ir_se", "ir"])
def test_irse_embeddings_and_round_trip_match_jax(irse, mode):
    v = irse[mode]
    port = _port(mode, v)
    x = np.random.RandomState(3).uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    want = JI.BackboneIRSE(mode=mode).apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    sd = {k: t for k, t in numpy_sd(port.state_dict()).items()
          if not k.endswith("num_batches_tracked")}
    assert_same_tree(convert_irse(sd), v)


@pytest.mark.parametrize("hw", [256, 512])
def test_id_loss_feats_match_jax(irse, hw):
    v = irse["ir_se"]
    x = np.random.RandomState(hw).uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32)
    want = JI.id_loss_feats(v, jnp.asarray(x))
    with torch.no_grad():
        got = TI.id_loss_feats(_port("ir_se", v), to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_id_loss_and_its_gradient_match_jax(irse):
    v = irse["ir_se"]
    rng = np.random.RandomState(4)
    y_hat, y = (rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32) for _ in range(2))
    want, want_g = jax.jit(jax.value_and_grad(lambda a: JI.id_loss(v, a, jnp.asarray(y))))(
        jnp.asarray(y_hat))
    yt = to_nchw(y_hat).requires_grad_(True)
    got = TI.id_loss(_port("ir_se", v), yt, to_nchw(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    got.backward()
    assert_grad_close(nhwc(yt.grad), np.asarray(want_g))
