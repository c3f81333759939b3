"""The port's tensor ops, audio frontend and pipeline geometry against the
JAX package on the same numpy inputs (f32 on the CPU; tolerances below)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.audio import melspectrogram, mel_chunks_for_frames, num_mel_chunks
from s2v_torch.models.fan import lm68_to_lm5
from s2v_torch.models.s3fd import pad_and_smooth_boxes
from s2v_torch.ops import convs as t_convs, image as t_image, warp as t_warp
from s2v_torch.ops.norms import instance_norm_2d, layer_norm_chw
from s2v_torch.pipeline import align as t_align, enhance as t_enh, utils as t_utils
from s2v_tpu.audio import melspec as j_mel
from s2v_tpu.models.fan import lm68_to_lm5 as j_lm68_to_lm5
from s2v_tpu.models.s3fd import pad_and_smooth_boxes as j_pad_smooth
from s2v_tpu.ops import convs as j_convs, image as j_image, norms as j_norms, warp as j_warp
from s2v_tpu.pipeline import align as j_align, enhance as j_enh, utils as j_utils
from torch_parity import one_torch_thread

RNG = np.random.RandomState(5)
ATOL = 1e-4  # f32 on values in [0, 255] or O(1); matmul vs interpolation order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("stride,padding,mode", [(1, 1, "reflect"), (2, 0, "zeros"),
                                                 (2, 2, "zeros")])
def test_conv2d_weights_match_torch_conv(stride, padding, mode):
    x = RNG.randn(2, 11, 10, 4).astype(np.float32)
    w = RNG.randn(3, 3, 4, 6).astype(np.float32)  # HWIO
    b = RNG.randn(6).astype(np.float32)
    want = j_convs.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                          padding=padding, padding_mode=mode)
    conv = torch.nn.Conv2d(4, 6, 3, stride, padding, padding_mode=mode)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(t_convs.conv_weight_from_hwio(w)))
        conv.bias.copy_(torch.from_numpy(b))
        got = conv(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)


def test_conv_transpose_and_dense_match_torch():
    """GPEN's transposed-conv upsample (stride 2, no padding) and a dense
    layer: s2v_tpu's rebuilt layers against torch's on the same weights."""
    x = RNG.randn(2, 7, 6, 4).astype(np.float32)
    w_iohw = RNG.randn(4, 5, 3, 3).astype(np.float32)  # torch ConvTranspose2d
    want = j_convs.conv_transpose2d(
        jnp.asarray(x), jnp.asarray(j_convs.torch_convtranspose_weight_to_hwoi(w_iohw)),
        stride=2, padding=0, output_padding=0)
    got = torch.nn.functional.conv_transpose2d(nchw(x), torch.from_numpy(w_iohw), stride=2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)
    v = RNG.randn(3, 8).astype(np.float32)
    wd, bd = RNG.randn(8, 5).astype(np.float32), RNG.randn(5).astype(np.float32)
    got = torch.nn.functional.linear(torch.from_numpy(v),
                                     torch.from_numpy(t_convs.linear_weight_from_dense(wd)),
                                     torch.from_numpy(bd))
    want = j_convs.dense(jnp.asarray(v), jnp.asarray(wd), jnp.asarray(bd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(17, 9), (40, 64), (13, 13)])
def test_resizes(out_hw):
    x = RNG.rand(2, 13, 21, 3).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(t_image.resize_bilinear(nchw(x), out_hw)),
        np.asarray(j_image.resize_bilinear(jnp.asarray(x), out_hw)), atol=1e-5)
    np.testing.assert_allclose(
        nhwc(t_image.resize_nearest(nchw(x), out_hw)),
        np.asarray(j_image.resize_nearest(jnp.asarray(x), out_hw)), atol=1e-6)


def test_norms():
    x = RNG.randn(2, 5, 6, 4).astype(np.float32)
    w, b = RNG.randn(4).astype(np.float32), RNG.randn(4).astype(np.float32)
    got = layer_norm_chw(nchw(x), torch.from_numpy(w).view(-1, 1, 1),
                         torch.from_numpy(b).view(-1, 1, 1))
    want = j_norms.layer_norm_chw(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(instance_norm_2d(nchw(x))),
                               np.asarray(j_norms.instance_norm_2d(jnp.asarray(x))),
                               atol=1e-5)


def test_box_warps():
    frames = (RNG.rand(3, 50, 60, 3) * 255).astype(np.float32)
    boxes = np.array([[5, 4, 40, 45], [0, 0, 60, 50], [10, 12, 30, 20]], np.float32)
    got = t_warp.crop_resize_boxes(nchw(frames), torch.from_numpy(boxes), (24, 24))
    want = j_warp.crop_resize_boxes(jnp.asarray(frames), jnp.asarray(boxes), (24, 24))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    preds = (RNG.rand(3, 24, 24, 3) * 255).astype(np.float32)
    got = t_warp.paste_resize_boxes(nchw(frames), nchw(preds), torch.from_numpy(boxes))
    want = j_warp.paste_resize_boxes(jnp.asarray(frames), jnp.asarray(preds),
                                     jnp.asarray(boxes))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_affine_warp(inverse):
    img = (RNG.rand(2, 40, 36, 5) * 255).astype(np.float32)
    ang = np.array([0.3, -0.2])
    mats = np.stack([[[1.1 * np.cos(a), -np.sin(a), 4.0], [np.sin(a), 0.9 * np.cos(a), -3.0]]
                     for a in ang]).astype(np.float32)
    got = t_warp.affine_warp(nchw(img), torch.from_numpy(mats), (31, 45), inverse)
    want = j_warp.affine_warp(jnp.asarray(img), jnp.asarray(mats), (31, 45), inverse)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-3)


def test_gaussian_blur_and_mask_postprocess():
    m = (RNG.rand(2, 512, 512, 1) > 0.5).astype(np.float32)
    got = t_utils.mask_postprocess(nchw(m), thres=26)
    want = j_utils.mask_postprocess(jnp.asarray(m), thres=26)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    x = RNG.rand(1, 30, 20, 2).astype(np.float32)
    np.testing.assert_allclose(nhwc(t_utils.gaussian_blur(nchw(x), 9, 1.0)),
                               np.asarray(j_utils.gaussian_blur(jnp.asarray(x), 9, 1.0)),
                               atol=1e-5)


def test_melspectrogram_and_chunks():
    t = np.arange(7000) / 16000.0
    wav = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * RNG.randn(len(t))).astype(np.float32)
    got = melspectrogram(torch.from_numpy(wav)).numpy()
    want = np.asarray(j_mel.melspectrogram(jnp.asarray(wav)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)  # dB scale in [-4, 4]
    n = num_mel_chunks(got.shape[1], 25.0)
    assert n == j_mel.num_mel_chunks(want.shape[1], 25.0)
    np.testing.assert_array_equal(
        mel_chunks_for_frames(torch.from_numpy(np.array(want)), n, 25.0).numpy(),
        np.asarray(j_mel.mel_chunks_for_frames(jnp.asarray(want), n, 25.0)))


def test_umeyama_and_reference_points():
    for size in (64, 2048):
        np.testing.assert_allclose(
            t_enh.get_reference_facial_points((size, size)),
            j_enh.get_reference_facial_points((size, size)), rtol=1e-6)
    ref = j_enh.get_reference_facial_points((512, 512))
    src = (RNG.rand(4, 5, 2) * 200).astype(np.float32)
    got, sc = t_enh.umeyama_similarity_batched(torch.from_numpy(src), torch.from_numpy(ref))
    want, wsc = j_enh.umeyama_similarity_batched(jnp.asarray(src), jnp.asarray(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(sc.numpy(), np.asarray(wsc), rtol=1e-5)


def test_small_face_filter():
    x = (RNG.rand(2, 20, 20, 3) * 255).astype(np.float32)
    np.testing.assert_allclose(nhwc(t_enh.small_face_filter(nchw(x))),
                               np.asarray(j_enh._small_face_filter(jnp.asarray(x))),
                               atol=ATOL)


def test_geometry_helpers():
    lm = (RNG.rand(6, 68, 2) * 200 + 20).astype(np.float32)
    np.testing.assert_allclose(lm68_to_lm5(lm), j_lm68_to_lm5(lm), rtol=1e-6)
    c, x, y = t_align.compute_transform(lm[0].astype(np.float64))
    cj, xj, yj = j_align.compute_transform(lm[0].astype(np.float64))
    np.testing.assert_allclose(np.stack([c, x, y]), np.stack([cj, xj, yj]))
    q = t_align.quad_from_cxy(c, x, y)
    np.testing.assert_allclose(q, j_align.quad_from_cxy(cj, xj, yj))
    for got, want in zip(t_align.crop_quad_params(q, (256, 256), 256),
                         j_align.crop_quad_params(q, (256, 256), 256)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want))
    for n in (3, 9):
        boxes = (RNG.rand(n, 4) * 80 + [0, 0, 80, 80]).astype(np.float32)
        np.testing.assert_array_equal(
            pad_and_smooth_boxes(boxes, (160, 150)),
            np.asarray(j_pad_smooth(jnp.asarray(boxes), (160, 150))).astype(np.int64))
