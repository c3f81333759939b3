"""The port's Step 2-3 pieces against s2v_tpu's, f32 on the CPU: ReconNet
and DNet at slim widths (the layer counts of the production geometry, so
s2v_tpu's converters read them), each new DNet block, the flow warp, the
coefficient windows, the FFHQ crop box, POS and ``align_img``.

Tolerances: network outputs within 1e-4 absolute, relative to the output's
scale where it exceeds 1 (f32, conv summation order); the warp within 1e-4
on values in [0, 1]; the host geometry (POS, crop box, coefficient windows)
exactly; ``align_img``'s image bit for bit against Pillow, which the JAX
package resizes with.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from s2v_torch.models import dnet as t_dnet
from s2v_torch.models import layers as t_layers
from s2v_torch.models.resnet import ReconNet as TReconNet
from s2v_torch.ops import warp as t_warp
from s2v_torch.pipeline import align as t_align
from s2v_torch.pipeline import face3d_prep as t_prep
from s2v_torch.pipeline import utils as t_utils
from s2v_torch.utils import weights as TW
from s2v_tpu.models import dnet as j_dnet
from s2v_tpu.models import layers as j_layers
from s2v_tpu.models.resnet import ReconNet
from s2v_tpu.ops import warp as j_warp
from s2v_tpu.pipeline import align as j_align
from s2v_tpu.pipeline import face3d_prep as j_prep
from s2v_tpu.pipeline import utils as j_utils
from s2v_tpu.utils import weights as JW
from test_pipeline_e2e import synthetic_landmarks
from test_torch_models import assert_same_tree, close, load, numpy_sd, to_nchw
from torch_parity import one_torch_thread, random_variables

RECON_KW = dict(layers=(1, 1, 1, 1), base_planes=8)
DNET_KW = dict(descriptor_nc=16, warp_base_nc=8, edit_base_nc=8, max_nc=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def test_recon_net_matches_jax_and_roundtrips():
    rng = np.random.RandomState(0)
    model = ReconNet(**RECON_KW)
    v = random_variables(model, (1, 96, 96, 3), seed=30)
    x = rng.rand(2, 96, 96, 3).astype(np.float32)
    want = jax.jit(model.apply)(v, x)
    port = load(TReconNet(**RECON_KW), TW.recon_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(x)).numpy()
    assert got.shape == (2, 257)
    close(got, want)
    sd = {k: a for k, a in numpy_sd(port.state_dict()).items()
          if not k.endswith("num_batches_tracked")}
    assert_same_tree(JW.convert_recon_net(sd, layers=RECON_KW["layers"]), v)
    full = set(TReconNet().state_dict())  # face3d_pretrain_epoch_20.pth net_recon's keys
    for k in ("backbone.conv1.weight", "backbone.layer1.0.downsample.0.weight",
              "backbone.layer4.2.bn3.running_var", "final_layers.6.bias"):
        assert k in full, k


def _block_sd(p, transposed=()):
    sd = {}
    for part, d in p.items():
        if part.startswith("norm"):
            TW._adain(d, part, sd)
        elif part in transposed:
            TW._conv_transpose(d, part, sd)
        else:
            TW._conv(d, part, sd)
    return sd


@pytest.mark.parametrize("block", ["encoder", "decoder", "fine_res"])
def test_dnet_blocks_match_jax(block):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    z = rng.randn(2, 16).astype(np.float32)
    if block == "encoder":
        jm, tm, tr = (j_layers.ADAINEncoderBlock(10, 16),
                      t_layers.ADAINEncoderBlock(6, 10, 16), ())
    elif block == "decoder":
        jm, tm, tr = (j_layers.ADAINDecoderBlock(5, 7, 16),
                      t_layers.ADAINDecoderBlock(6, 5, 7, 16), ("conv_1", "conv_s"))
    else:
        jm, tm, tr = j_layers.FineADAINResBlock2d(6), t_layers.FineADAINResBlock2d(6, 16), ()
    v = random_variables(jm, x.shape, z.shape, seed=31)
    want = jax.jit(jm.apply)(v, x, z)
    port = load(tm, _block_sd(v["params"], tr))
    with torch.no_grad():
        got = port(to_nchw(x), torch.from_numpy(z)).numpy()
    close(got.transpose(0, 2, 3, 1), want)


@pytest.fixture(scope="module")
def dnet_run():
    rng = np.random.RandomState(2)
    model = j_dnet.DNet(**DNET_KW)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    coeff = rng.randn(2, 26, 73).astype(np.float32)
    v = random_variables(model, img.shape, coeff.shape, seed=32)
    want = {k: np.asarray(a) for k, a in jax.jit(model.apply)(v, img, coeff).items()}
    port = load(t_dnet.DNet(**DNET_KW), TW.dnet_from_jax(v))
    with torch.no_grad():
        got = port(to_nchw(img), torch.from_numpy(coeff.transpose(0, 2, 1).copy()))
    return v, want, {k: a.numpy().transpose(0, 2, 3, 1) for k, a in got.items()}


def test_dnet_matches_jax(dnet_run):
    """flow (16^2 from a 64^2 input), the warp it drives (the flow upsampled
    to 64^2 first), the edited image; the hourglass, mapping net, fine
    encoder and decoder all run inside."""
    _, want, got = dnet_run
    assert got["flow_field"].shape == (2, 16, 16, 2)
    for k in ("flow_field", "warp_image", "fake_image"):
        close(got[k], want[k])


def test_dnet_converter_roundtrip_and_reference_names(dnet_run):
    v, _, _ = dnet_run
    sd = numpy_sd(load(t_dnet.DNet(**DNET_KW), TW.dnet_from_jax(v)).state_dict())
    assert_same_tree(JW.convert_dnet(sd), v)
    full = set(t_dnet.DNet().state_dict())  # DNet.pt's keys
    for k in ("mapping_net.first.0.weight", "mapping_net.encoder2.1.bias",
              "warpping_net.hourglass.encoder.input_layer.weight",
              "warpping_net.hourglass.encoder.encoder4.norm_1.mlp_shared.0.weight",
              "warpping_net.hourglass.decoder.decoder2.conv_s.weight",
              "warpping_net.flow_out.0.weight", "warpping_net.flow_out.2.bias",
              "editing_net.encoder.first.model.0.weight",
              "editing_net.decoder.res0.res1.conv1.weight",
              "editing_net.decoder.jump2.model.1.bias", "editing_net.decoder.final.model.0.weight"):
        assert k in full, k


def test_flow_warp_matches_jax():
    rng = np.random.RandomState(3)
    flow = (rng.randn(2, 9, 11, 2) * 2).astype(np.float32)
    want = j_warp.convert_flow_to_deformation(jnp.asarray(flow))
    got = t_warp.convert_flow_to_deformation(to_nchw(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    img = rng.rand(2, 36, 44, 3).astype(np.float32)
    want = j_warp.warp_image(jnp.asarray(img), want)
    got = t_warp.warp_image(to_nchw(img), got)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4)


def test_coefficient_windows_match_jax():
    rng = np.random.RandomState(4)
    sem = rng.randn(9, 262).astype(np.float32)
    ratio = rng.rand(9).astype(np.float32) + 0.5
    for r in (None, ratio):
        want = j_utils.transform_semantic(jnp.asarray(sem), None if r is None else jnp.asarray(r))
        got = t_utils.transform_semantic(torch.from_numpy(sem),
                                         None if r is None else torch.from_numpy(r))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_utils.find_crop_norm_ratio(torch.from_numpy(sem[2:3]), torch.from_numpy(sem)).numpy(),
        np.asarray(j_utils.find_crop_norm_ratio(jnp.asarray(sem[2:3]), jnp.asarray(sem))))
    for k, a in t_utils.split_coeff(torch.from_numpy(sem[:, :257])).items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(j_utils.split_coeff(sem[:, :257])[k]))


def test_ffhq_crop_box_pos_and_5p_match_jax():
    for (h, w) in ((160, 144), (512, 512), (90, 300)):
        lm = synthetic_landmarks(1, h, w)[0].astype(np.float64)
        assert t_align.ffhq_crop_box(lm, (w, h), 512) == j_align.ffhq_crop_box(lm, (w, h), 512)
    rng = np.random.RandomState(5)
    lm = rng.rand(68, 2) * 200
    np.testing.assert_array_equal(t_prep.extract_5p(lm), j_prep.extract_5p(lm))
    x3d = rng.randn(3, 5)
    xp = rng.randn(2, 5) * 30 + 100
    t, s = t_prep.POS(xp, x3d)
    tj, sj = j_prep.POS(xp, x3d)
    np.testing.assert_array_equal(t, tj)
    assert s == sj


@pytest.mark.parametrize("seed", range(4))
def test_resize_bicubic_and_crop_match_pillow(seed):
    """Random sizes, up- and downscales (to 1/5: the support widens), one
    axis unchanged, and a piecewise-constant image whose edges overshoot
    [0, 255] and clip."""
    rng = np.random.RandomState(40 + seed)
    for it in range(12):
        h, w = rng.randint(1, 200, 2)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        if it % 3 == 0:
            img = (img // 64 * 85).astype(np.uint8)
        size = tuple(max(1, int(n * rng.uniform(0.2, 3.0))) for n in (w, h))
        if it % 4 == 0:
            size = (w, size[1])
        want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
        np.testing.assert_array_equal(t_prep.resize_bicubic_u8(img, size), want)
        left, up = rng.randint(-40, 40, 2)
        box = (int(left), int(up), int(left + rng.randint(1, 250)), int(up + rng.randint(1, 250)))
        np.testing.assert_array_equal(t_prep.crop_zero(img, box),
                                      np.asarray(Image.fromarray(img).crop(box)))


@pytest.mark.parametrize("spread", [0.6, 1.0, 2.5])
def test_align_img_matches_jax(spread):
    """Faces of three sizes in a 256^2 frame (landmarks y-up, as the
    pipeline hands them over): upscale, near 1 and a downscale, with the
    crop past the frame's edge."""
    rng = np.random.RandomState(6)
    img = (rng.rand(256, 256, 3) * 255).astype(np.uint8)
    lm = synthetic_landmarks(1, 256, 256)[0].astype(np.float64)
    lm = (lm - 128) * spread + 128 + rng.randn(68, 2)
    lm[:, 1] = 255 - lm[:, 1]
    lm3d = np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                       [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float64)
    tp, aligned, lm_new = t_prep.align_img(img, lm, lm3d)
    tpj, alignedj, lm_newj = j_prep.align_img(Image.fromarray(img), lm, lm3d)
    np.testing.assert_array_equal(tp, tpj)
    assert aligned.shape == (224, 224, 3)
    np.testing.assert_array_equal(aligned, np.asarray(alignedj))
    np.testing.assert_array_equal(lm_new, lm_newj)


def test_load_lm3d_matches_jax(tmp_path):
    from scipy.io import savemat

    savemat(tmp_path / "similarity_Lm3D_all.mat",
            {"lm": np.random.RandomState(7).randn(68, 3)})
    np.testing.assert_array_equal(t_prep.load_lm3d(str(tmp_path)), j_prep.load_lm3d(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        t_prep.load_lm3d(str(tmp_path / "missing"))
