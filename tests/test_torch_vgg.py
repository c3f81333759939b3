"""The port's VGG16 features and perceptual loss (s2v_torch.models.vgg)
against s2v_tpu's on the CPU, f32, from the same random weights. VGG16's
widths are fixed, so it runs at batch 1 on small inputs.

- The four block activations and the loss with and without the 224 resize
  (and with Gram style terms) within rtol 1e-4 (f32, conv summation
  order, summed over four blocks).
- The gradient with respect to ``pred`` within a relative L2 error of 1e-3
  (``assert_grad_close``).
- The round trip through s2v_tpu's ``convert_vgg16_features``; a
  torchvision-layout file loads (its deeper convs and classifier
  ignored), one without ``features.14.weight`` raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2v_torch.models import vgg as TV
from s2v_torch.utils import weights as TW
from s2v_tpu.models import vgg as JV
from test_torch_models import assert_same_tree, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_grad_close(got, want, rel=1e-3):
    """An input gradient through L1 terms and ReLU / PReLU gates, held in
    norm. Elementwise it is discontinuous where an activation pair (L1's
    sign) or a pre-activation (a gate) lies within f32 rounding of a tie:
    the two frameworks, summing in other orders, may take opposite sides
    there, and an isolated entry then differs by one tie's contribution
    (measured: up to 0.9% of the largest entry, on at most 0.18% of the
    entries, VGG16 through the 224 resize). Relative L2 errors measured:
    VGG16 5.8e-4, 5.5e-4 and 2.2e-5; id_loss 1.4e-4."""
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rel, f"gradient relative L2 error {err:.3g} > {rel}"


@pytest.fixture(scope="module")
def vgg():
    v = random_variables(JV.VGG16Features(), (1, 32, 32, 3), seed=11)
    return v, load(TV.VGG16Features(), TW.vgg16_from_jax(v))


def test_vgg16_blocks_match_jax(vgg):
    v, port = vgg
    x = np.random.RandomState(1).rand(1, 64, 48, 3).astype(np.float32)
    want = JV.VGG16Features().apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(to_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("resize, hw, style", [(True, 96, ()), (False, 48, ()),
                                               (False, 48, (1, 2))])
def test_vgg_perceptual_loss_and_its_gradient_match_jax(vgg, resize, hw, style):
    v, port = vgg
    rng = np.random.RandomState(2)
    pred, target = (rng.rand(1, hw, hw, 3).astype(np.float32) for _ in range(2))

    def loss(p):
        return JV.vgg_perceptual_loss(v, p, jnp.asarray(target), style_layers=style,
                                      resize=resize)

    want, want_g = jax.value_and_grad(loss)(jnp.asarray(pred))
    pt = to_nchw(pred).requires_grad_(True)
    got = TV.vgg_perceptual_loss(port.requires_grad_(False), pt, to_nchw(target),
                                 style_layers=style, resize=resize)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    got.backward()
    assert_grad_close(nhwc(pt.grad), np.asarray(want_g))


def test_vgg16_round_trip_and_torchvision_file(vgg):
    v, port = vgg
    sd = port.state_dict()
    assert_same_tree(JV.convert_vgg16_features(numpy_sd(sd)), v)
    # a torchvision file carries the convs past layer 21 and the classifier
    full = dict(sd, **{"features.24.weight": torch.zeros(512, 512, 3, 3),
                       "features.24.bias": torch.zeros(512),
                       "classifier.0.weight": torch.zeros(8, 4)})
    loaded = TV.vgg16_features(full)
    assert all(torch.equal(loaded.state_dict()[k], t) for k, t in sd.items())
    del full["features.14.weight"]
    with pytest.raises(KeyError, match="features.14.weight"):
        TV.vgg16_features(full)
