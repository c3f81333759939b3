"""The port's model export (s2v_torch/utils/export.py) against s2v_tpu's
StableHLO export (tests/test_misc_utils.py::test_stablehlo_export_roundtrip):

- the same function, ``tanh(x @ w)``, exported, saved to bytes, loaded on
  the CPU and run: equal to eager within 1e-6 relative, as there, and
  ``check_parity`` within its 1e-5; the JAX export gives the same values
  within 1e-6;
- a slim GPEN generator (``test_torch_models``' slim widths) from the JAX
  variables, exported and reloaded on the CPU: equal to eager (the loaded
  program runs the same plain versions), within ``test_torch_models``'
  bound (1e-4 of scale) of the JAX forward, and its graph holds one
  ``s2v::fused_act_fwd`` node per K1 site and one ``s2v::upfirdn2d`` per
  K3 site (``kernel_sites``): the kernels stay operators in the program;
- the three ``s2v`` operators pass ``torch.library.opcheck`` on the CPU
  (schema, fake implementation, dispatch) at GPEN's shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models.gpen import BLUR_TAPS, FullGenerator as TGPEN, make_kernel
from s2v_torch.train.gan import kernel_sites
from s2v_torch.utils import weights as TW
from s2v_torch.utils.export import (check_parity, export_program, load_exported, load_program,
                                    s2v_nodes, save)
from s2v_tpu.models.gpen import FullGenerator
from s2v_tpu.utils.export import export_stablehlo
from s2v_tpu.utils.export import load_exported as jax_load_exported
from test_torch_models import GPEN_KW, close, load, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_export_roundtrip(tmp_path):
    def fn(x, w):
        return torch.tanh(x @ w)

    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    blob = export_program(fn, (tx, tw))
    assert isinstance(blob, (bytes, bytearray)) and len(blob) > 100
    restored = load_exported(blob, device="cpu")
    np.testing.assert_allclose(restored(tx, tw).numpy(), fn(tx, tw).numpy(), rtol=1e-6)
    ok, err = check_parity(fn, blob, (tx, tw), device="cpu")
    assert ok, err
    want = jax_load_exported(export_stablehlo(lambda a, b: jnp.tanh(a @ b), (x, w)))(x, w)
    np.testing.assert_allclose(restored(tx, tw).numpy(), np.asarray(want), rtol=1e-6)
    path = save(str(tmp_path / "fn.pt2"), fn, (tx, tw))
    with open(path, "rb") as f:
        np.testing.assert_allclose(load_exported(f.read(), "cpu")(tx, tw).numpy(),
                                   fn(tx, tw).numpy(), rtol=1e-6)


def test_gpen_exports_with_its_kernels_as_operators():
    rng = np.random.RandomState(2)
    model = FullGenerator(**GPEN_KW)
    v = random_variables(model, (1, 64, 64, 3), seed=2, equalized=True)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(model.apply)(v, x)
    port = load(TGPEN(**GPEN_KW), TW.gpen_from_jax(v))
    xt = to_nchw(x)
    blob = export_program(port, (xt,))
    k1, k3 = kernel_sites(port)
    assert s2v_nodes(load_program(blob)) == {"fused_act_fwd": k1, "upfirdn2d": k3}
    got = load_exported(blob, device="cpu")(xt)
    with torch.no_grad():
        eager = port(xt)
    assert torch.equal(got, eager)
    close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operators_pass_opcheck(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 7, generator=g, dtype=dtype)
    b = torch.randn(8, generator=g, dtype=dtype)
    out = torch.ops.s2v.fused_act_fwd(x, b, 0.2, 2 ** 0.5)
    fir = (make_kernel(BLUR_TAPS) * 4).ravel().tolist()
    for op, args in ((torch.ops.s2v.fused_act_fwd.default, (x, b, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.fused_act_bwd.default, (x, out, None, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.fused_act_bwd.default, (x, out, b, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.upfirdn2d.default, (x, fir, 4, 4, 2, 1, 2, 1, 2, 1)),
                     (torch.ops.s2v.upfirdn2d.default, (x, fir, 4, 4, 1, 2, 1, 1, -1, 2))):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
