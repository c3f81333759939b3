"""The port's per-layer diagnostics (s2v_torch.utils.diagnostics) against the
JAX package's on the CPU.

- ``Diagnostic``: the same arrays (tensors here, numpy there), per axis and
  flat, accumulated twice: ``rows()`` equal and the CSV files byte-equal.
- ``tree_stats`` and ``global_norm`` over a slim RRDBNet's ``state_dict``
  against the same statistics of its flax tree (weights from
  ``rrdbnet_from_jax``; a layout change moves no mean, deviation or
  maximum): within 1e-6 relative (f32 sums in another order).
- ``capture_activations``: one entry per submodule that ran (each a
  one-call tuple), the forward's own output returned, and no hook left
  behind, also when the forward raises.
"""

import re

import numpy as np
import pytest
import torch

from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.utils import diagnostics as TD
from s2v_torch.utils import weights as TW
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.utils import diagnostics as JD
from test_torch_models import RRDB_KW, load, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_diagnostic_rows_and_csv_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    arrays = {"conv/weight": rng.randn(4, 3, 3, 3).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32),
              "act": rng.randn(2, 6, 7, 8).astype(np.float32)}
    port, jax_diag = TD.Diagnostic("t", max_pca_dim=7), JD.Diagnostic("t", max_pca_dim=7)
    for _ in range(2):
        port.accumulate_tree({k: torch.from_numpy(v) for k, v in arrays.items()}, kind="grad")
        jax_diag.accumulate_tree(arrays, kind="grad")
        port.accumulate("flat", torch.from_numpy(arrays["act"]), per_axis=False)
        jax_diag.accumulate("flat", arrays["act"], per_axis=False)
    assert port.rows() == jax_diag.rows()
    assert len(port.rows()) == 4 + 1 + 4 + 1
    got = port.to_csv(str(tmp_path / "port" / "diag.csv"))
    want = jax_diag.to_csv(str(tmp_path / "jax" / "diag.csv"))
    assert open(got).read() == open(want).read()


@pytest.fixture(scope="module")
def rrdb():
    v = random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3), seed=2)
    return v, load(TRRDBNet(**RRDB_KW), TW.rrdbnet_from_jax(v))


def test_tree_stats_and_global_norm_match_jax(rrdb):
    v, port = rrdb
    got = {k: float(t) for k, t in TD.tree_stats(port.state_dict()).items()}
    want = {k: float(t) for k, t in JD.tree_stats(v["params"]).items()}
    assert len(got) == len(want) == 3 * len(port.state_dict())
    for k, w in want.items():  # body0/rdb1/conv1/weight.mean -> body.0.rdb1.conv1.weight.mean
        name = re.sub(r"^body(\d+)", r"body.\1", k).replace("/", ".")
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(TD.global_norm(port.state_dict())),
                               float(JD.global_norm(v["params"])), rtol=1e-6)


def _hooks(module):
    return sum(len(m._forward_hooks) for m in module.modules())


def test_capture_activations_records_every_submodule_and_cleans_up(rrdb):
    port = rrdb[1]
    x = to_nchw(np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        out, acts = TD.capture_activations(port, x)
        want = port(x)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert set(acts) == {n for n, _ in port.named_modules() if n}
    assert all(len(v) == 1 for v in acts.values())
    assert acts["conv_last"][0].shape == want.shape
    assert _hooks(port) == 0
    diag = TD.Diagnostic()
    diag.accumulate_tree(acts, kind="output")
    assert any(r["name"] == "conv_last/0/output/axis_1" for r in diag.rows())
    with pytest.raises(RuntimeError):
        TD.capture_activations(port, x[:, :2])  # the first conv takes 12 channels
    assert _hooks(port) == 0
