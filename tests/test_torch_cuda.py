"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA card and nvcc; it carries the ``cuda``
marker and skips elsewhere. The file imports neither jax nor s2v_tpu, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Tolerances:
f32 1e-5 absolute (same arithmetic, f32 accumulation in both); bf16 1e-2 of
the output's largest magnitude (the kernels round once, the plain versions
after every operation).
"""

import numpy as np
import pytest
import torch

from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_plain,
                                   launch_counts, upfirdn2d, upfirdn2d_plain)

ATOL = 1e-5

# (up, down, pad, taps): the StyleGAN2 use sites of tests/test_pallas_ops.py,
# the three GPEN-2048 configurations, a negative pad (a crop) and a mixed case
CASES = [
    (1, 1, (2, 1), [1, 3, 3, 1]),
    (2, 1, (2, 1), [1, 3, 3, 1]),
    (1, 2, (1, 1), [1, 3, 3, 1]),
    (1, 1, (1, 1), [1, 2, 1]),
    (1, 1, (1, 1), [1, 3, 3, 1]),   # blur after each transposed conv
    (1, 1, (2, 2), [1, 3, 3, 1]),   # blur before each stride-2 encoder conv
    (2, 1, (2, 1), [1, 3, 3, 1]),   # ToRGB skip upsample
    (1, 1, (-1, 2), [1, 3, 3, 1]),  # negative pad crops
    (2, 2, (0, -1), [1, 2, 1]),
]


def blur_kernel(taps, up=1):
    k = np.outer(taps, taps).astype(np.float32)
    return k / k.sum() * up ** 2


def tolerance(dtype, want):
    return ATOL if dtype == torch.float32 else 1e-2 * want.abs().max().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain conv in full f32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 64, 64), (3, 7, 5, 3), (4, 512)])
def test_fused_act_kernel_matches_plain(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    b = torch.randn(shape[1], generator=g, device=card)
    before = launch_counts()["fused_act"]
    got = fused_bias_leaky_relu(x, b).float()
    assert launch_counts()["fused_act"] == before + 1
    want = fused_bias_leaky_relu_plain(x, b).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tolerance(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_kernel_matches_plain(card, dtype, up, down, pad, taps):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(2, 16, 33, 2049, generator=g, device=card).to(dtype)
    k = blur_kernel(taps, up)
    before = launch_counts()["upfirdn2d"]
    got = upfirdn2d(x, k, up, down, pad).float()
    assert launch_counts()["upfirdn2d"] == before + 1
    want = upfirdn2d_plain(x, k, up, down, pad).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tolerance(dtype, want)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.randn(1, 4, 8, 8, device=card)
    with pytest.raises(TypeError):
        fused_bias_leaky_relu(x.half(), torch.zeros(4, device=card))
    with pytest.raises(ValueError):
        fused_bias_leaky_relu(x, torch.zeros(3, device=card))
    with pytest.raises(ValueError):
        upfirdn2d(x, np.ones((5, 5), np.float32))
    with pytest.raises(NotImplementedError):
        upfirdn2d(x.requires_grad_(), blur_kernel([1, 3, 3, 1]))
