"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA card and nvcc; it carries the ``cuda``
marker and skips elsewhere. The file imports neither jax nor s2v_tpu, so it
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Tolerances:
f32 1e-5 absolute (same arithmetic, f32 accumulation in both); bf16 1e-2 of
the output's largest magnitude (the kernels round once, the plain versions
after every operation). Gradients (backward and double backward through the
autograd Functions, against PyTorch's autograd of the plain versions on the
card): f32 1e-4 and bf16 2e-2 of the largest magnitude where it exceeds 1
(second-order gradients are sums over many elements; bf16 rounds twice more
on the plain side).
"""

import numpy as np
import pytest
import torch

from s2v_torch.ops.kernels import (fused_bias_leaky_relu, fused_bias_leaky_relu_bwd,
                                   fused_bias_leaky_relu_bwd_plain, fused_bias_leaky_relu_plain,
                                   launch_counts, upfirdn2d, upfirdn2d_plain)
from s2v_torch.ops.kernels.upfirdn2d import grad_pad, out_size, upfirdn2d_fwd

ATOL = 1e-5

# (up, down, pad, taps): the StyleGAN2 use sites of tests/test_pallas_ops.py,
# the three GPEN-2048 configurations, a negative pad (a crop), mixed cases,
# a 1-tap and a 2-tap FIR, and a down=2 and an up=2 down=2 case with wide pads
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
    (1, 1, (1, 0), [1]),
    (2, 1, (0, 1), [1, 1]),
    (1, 2, (2, 2), [1, 3, 3, 1]),
    (2, 2, (2, 1), [1, 3, 3, 1]),
]

# input shapes for the edges of K3's plan (a warp takes 128 output columns
# and a chunk of up to 64 rows, 8 on planes this short; outputs under 40
# columns take the one-thread-per-output kernel): GPEN-2048's width, a plane
# of a few outputs, widths around 40, outputs one row past a chunk and one
# column past a strip, GPEN-512 training's odd widths, and the component
# discriminator's eye-crop planes before conv4 (40^2 in, 41 columns out of
# the blur with pad (2, 2); its backward's 39^2 in, 40 out)
SHAPES = [(2, 16, 33, 2049), (1, 3, 1, 7), (1, 3, 40, 41), (1, 4, 66, 130), (1, 4, 67, 131),
          (1, 2, 513, 513), (1, 2, 511, 511), (1, 8, 40, 40), (1, 8, 39, 39)]


def blur_kernel(taps, up=1):
    k = np.outer(taps, taps).astype(np.float32)
    return k / k.sum() * up ** 2


def tolerance(dtype, want, bf16=1e-2):
    return ATOL if dtype == torch.float32 else bf16 * want.abs().max().item()


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
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_kernel_matches_plain(card, dtype, up, down, pad, taps, shape):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    k = blur_kernel(taps, up)
    before = launch_counts()["upfirdn2d"]
    if min(out_size(n, len(taps), up, down, pad) for n in shape[2:]) < 1:
        with pytest.raises(ValueError):  # an empty output launches nothing
            upfirdn2d(x, k, up, down, pad)
        assert launch_counts()["upfirdn2d"] == before
        return
    got = upfirdn2d(x, k, up, down, pad).float()
    assert launch_counts()["upfirdn2d"] == before + 1
    want = upfirdn2d_plain(x, k, up, down, pad).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tolerance(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,kh,kw", [(1, 1, (2, 1), 4, 4), (2, 1, (2, 1), 4, 3),
                                               (1, 2, (1, 2), 3, 4), (2, 2, (1, 1), 3, 3)])
def test_upfirdn2d_kernel_non_separable_fir_matches_plain(card, dtype, up, down, pad, kh, kw):
    """A random FIR, which is no outer product, on outputs wide enough for
    the strip kernel: K3 takes its direct path (every FIR of GPEN's, and of
    CASES, factors into two 1-D FIRs, which the strip kernel needs)."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(2, 3, 37, 70, generator=g, device=card).to(dtype)
    k = np.random.RandomState(kh * 4 + kw).randn(kh, kw).astype(np.float32)
    before = launch_counts()["upfirdn2d"]
    got = upfirdn2d(x, k, up, down, pad).float()
    assert launch_counts()["upfirdn2d"] == before + 1
    want = upfirdn2d_plain(x, k, up, down, pad).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tolerance(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_fwd_per_axis_pads_matches_plain(card, dtype, up, down, pad, taps):
    """Each axis with its own pads on an H != W input, as the backward runs
    K3: a forward with pads that differ per axis, then its gradient's
    configuration (the flipped FIR, up and down swapped, each axis's pads
    from grad_pad), whose output has the forward input's size."""
    g = torch.Generator(device=card).manual_seed(3)
    k = blur_kernel(taps, up)
    kf = np.ascontiguousarray(k[::-1, ::-1])
    h, w = 37, 70
    pad_x = (pad[1], pad[0] - 1)
    oh, ow = out_size(h, k.shape[0], up, down, pad), out_size(w, k.shape[1], up, down, pad_x)
    x = torch.randn(2, 8, h, w, generator=g, device=card).to(dtype)
    grad = torch.randn(2, 8, oh, ow, generator=g, device=card).to(dtype)
    gpy = grad_pad(h, oh, k.shape[0], up, down, pad)
    gpx = grad_pad(w, ow, k.shape[1], up, down, pad_x)
    for args, size in (((x, k, up, down, pad, pad_x), (oh, ow)),
                       ((grad, kf, down, up, gpy, gpx), (h, w))):
        before = launch_counts()["upfirdn2d"]
        got = upfirdn2d_fwd(*args).float()
        assert launch_counts()["upfirdn2d"] == before + 1
        want = upfirdn2d_plain(*args).float()
        torch.cuda.synchronize()
        assert got.shape == want.shape == (2, 8, *size)
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
    with pytest.raises(ValueError):
        fused_bias_leaky_relu_bwd(x, x[:, :, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 64, 64), (3, 7, 5, 3), (4, 512)])
def test_fused_act_bwd_kernel_matches_plain(card, dtype, shape, with_bias):
    g = torch.Generator(device=card).manual_seed(1)
    grad = torch.randn(shape, generator=g, device=card).to(dtype)
    out = torch.randn(shape, generator=g, device=card).to(dtype)
    b = torch.randn(shape[1], generator=g, device=card) if with_bias else None
    before = launch_counts()["fused_act_bwd"]
    got = fused_bias_leaky_relu_bwd(grad, out, b).float()
    assert launch_counts()["fused_act_bwd"] == before + 1
    want = fused_bias_leaky_relu_bwd_plain(grad, out, b).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tolerance(dtype, want)


def _first_and_second_grads(fn, inputs, w, loss=lambda out, w: (out * w).sum()):
    """The gradients of ``loss(fn(*inputs), w)`` with create_graph, then the
    gradients of the sum of their squares, all with respect to ``inputs``."""
    first = torch.autograd.grad(loss(fn(*inputs), w), inputs, create_graph=True)
    second = torch.autograd.grad(sum(f.float().square().sum() for f in first), inputs,
                                 allow_unused=True)
    second = [torch.zeros_like(i) if s is None else s for i, s in zip(inputs, second)]
    return [t.float() for t in (*first, *second)]


def _grad_tolerance(dtype, want):
    scale = max(1.0, want.abs().max().item())
    return (1e-4 if dtype == torch.float32 else 2e-2) * scale


def _scaled(act, x, b, s):
    """act(x, b) * s[c]: the incoming gradient of the activation depends on
    s, so the double backward runs K2 on the backward (with b: the gradient
    of dbias) and on the forward (its output reaches s's gradient), as R1
    does. One layer, so the kernel and the plain version see the same signs
    (a second layer's input would carry the first's bf16 rounding across
    zero and flip its slope)."""
    return act(x, b) * s.view(1, -1, *([1] * (x.dim() - 2))).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 16, 16), (4, 64)])
def test_fused_act_function_backward_and_double_backward(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(shape, generator=g, device=card).to(dtype).requires_grad_()
    # a bias the working dtype holds exactly: the plain version rounds it to
    # that dtype before the add, and an x + b that this rounding carries
    # across zero would flip the slope of one element
    b = torch.randn(shape[1], generator=g, device=card).to(dtype).float().requires_grad_()
    s = torch.randn(shape[1], generator=g, device=card).requires_grad_()
    w = torch.randn(shape, generator=g, device=card).to(dtype)
    before = launch_counts()
    got = _first_and_second_grads(lambda *a: _scaled(fused_bias_leaky_relu, *a), (x, b, s), w)
    after = launch_counts()
    assert after["fused_act"] == before["fused_act"] + 1
    # the backward, its double backward, the forward's backward again
    assert after["fused_act_bwd"] == before["fused_act_bwd"] + 3
    want = _first_and_second_grads(lambda *a: _scaled(fused_bias_leaky_relu_plain, *a),
                                   (x, b, s), w)
    torch.cuda.synchronize()
    for a, ref in zip(got, want):
        assert a.shape == ref.shape
        assert (a - ref).abs().max().item() <= _grad_tolerance(dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,taps", CASES)
def test_upfirdn2d_function_backward_and_double_backward(card, dtype, up, down, pad, taps):
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(2, 8, 33, 47, generator=g, device=card).to(dtype).requires_grad_()
    k = blur_kernel(taps, up)
    w = torch.randn(upfirdn2d_plain(x, k, up, down, pad).shape, generator=g,
                    device=card).to(dtype)

    def half_square(out, w):  # the first gradient depends on x again
        return (out.float().square() * w).sum() / 2

    before = launch_counts()["upfirdn2d"]
    got = _first_and_second_grads(lambda a: upfirdn2d(a, k, up, down, pad), (x,), w,
                                  half_square)
    # forward, backward, the backward's backward, the forward's backward again
    assert launch_counts()["upfirdn2d"] == before + 4
    want = _first_and_second_grads(lambda a: upfirdn2d_plain(a, k, up, down, pad), (x,), w,
                                   half_square)
    torch.cuda.synchronize()
    for a, ref in zip(got, want):
        assert a.shape == ref.shape
        assert (a - ref).abs().max().item() <= _grad_tolerance(dtype, ref)


def _outputs(out):
    """Every tensor of a module's output (a tensor, a dict or a list of pairs)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return list(out.values())
    return [t for pair in out for t in pair]


def _steps_module(name):
    """Step 1-3 modules and inputs: S3FD at full width on 128^2 frames, FAN
    with one module on 128^2 crops, ReconNet and DNet slim (DNet on 64^2,
    whose flow is upsampled to the image before the warp)."""
    from s2v_torch.models.dnet import DNet
    from s2v_torch.models.fan import FAN
    from s2v_torch.models.resnet import ReconNet
    from s2v_torch.models.s3fd import S3FD

    torch.manual_seed(6)
    if name == "s3fd":
        return S3FD(), (torch.rand(2, 3, 128, 128) * 255 - 110,)
    if name == "fan":
        return FAN(num_modules=1), (torch.rand(2, 3, 128, 128),)
    if name == "recon":
        return ReconNet(layers=(1, 1, 1, 1), base_planes=8), (torch.rand(2, 3, 96, 96),)
    return DNet(16, 8, 8, 32), (torch.rand(2, 3, 64, 64) * 2 - 1, torch.randn(2, 73, 26))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["s3fd", "fan", "recon", "dnet"])
def test_steps_modules_on_the_card_match_the_cpu(card, name):
    """f32 without TF32 (the card fixture), so cuDNN and the CPU differ only
    in summation order: 1e-4 of each output's scale."""
    module, inputs = _steps_module(name)
    module.eval()
    with torch.no_grad():
        want = _outputs(module(*inputs))
        got = _outputs(module.to(card)(*[i.to(card) for i in inputs]))
    assert len(got) == len(want)
    for a, ref in zip(got, want):
        assert a.shape == ref.shape
        assert (a.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
def test_fan_crop_and_decode_on_the_card_match_the_cpu(card):
    """The FAN pre-crop within 1e-5 (values in [0, 1]); the heatmap decode on
    identical heatmaps within 1e-3 px (the argmax and +-0.25 steps equal)."""
    from s2v_torch.models.fan import box_to_center_scale, crop_faces_batched, heatmaps_to_landmarks

    g = torch.Generator().manual_seed(7)
    images = torch.rand(3, 3, 90, 110, generator=g) * 255
    boxes = torch.tensor([[10, 12, 70, 80], [-20, -5, 60, 50], [50, 40, 130, 120]],
                         dtype=torch.float32)
    hm = torch.randn(3, 68, 64, 64, generator=g)
    want = [crop_faces_batched(images, *box_to_center_scale(boxes)),
            heatmaps_to_landmarks(hm, *box_to_center_scale(boxes))]
    cb = box_to_center_scale(boxes.to(card))
    got = [crop_faces_batched(images.to(card), *cb), heatmaps_to_landmarks(hm.to(card), *cb)]
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-5
    assert (got[1].cpu() - want[1]).abs().max().item() <= 1e-3


def _retinaface(backbone):
    """RetinaFace with its level-2 face logit raised (``ClassHead.2``
    channels 1 and 3 by 4, that head's weights scaled by 10), so random
    weights find a face with a margin over the other anchors."""
    from s2v_torch.models.retinaface import RetinaFace, retinaface_mnet

    torch.manual_seed(8)
    model = RetinaFace() if backbone == "re50" else retinaface_mnet()
    with torch.no_grad():
        model.ClassHead[2].conv1x1.weight *= 10.0
        model.ClassHead[2].conv1x1.bias[[1, 3]] += 4.0
    return model.eval()


def _frames(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    base = torch.stack([xx * 255.0 / w, yy * 255.0 / h, (xx + yy) * 127.0 / (h + w)], -1)
    return torch.clamp(base + torch.randn(n, h, w, 3, generator=g) * 20, 0, 255).to(torch.uint8)


@pytest.mark.cuda
def test_retinaface_on_the_card_matches_the_cpu(card):
    """RetinaFace-R50 at full width on 256^2 frames, f32 without TF32:
    outputs within 1e-4 of their scale; the best box and landmarks within
    1e-2 px where the top-2 face-score margin exceeds twice the measured
    score difference (every frame here)."""
    from s2v_torch.models.retinaface import RETINA_MEAN, detect_faces

    model = _retinaface("re50")
    x = _frames(2, 256, 256, 9).permute(0, 3, 1, 2).float().flip(1)
    x = x - torch.tensor(RETINA_MEAN).view(1, 3, 1, 1)
    with torch.no_grad():
        want = model(x)
        got = [o.cpu() for o in model.to(card)(x.to(card))]
    for a, ref in zip(got, want):
        assert a.shape == ref.shape
        assert (a - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    top = want[1][..., 1].topk(2, dim=1).values
    assert ((top[:, 0] - top[:, 1]) > 2 * (got[1] - want[1]).abs().max()).all()
    dw, dg = detect_faces(want, (256, 256)), detect_faces(got, (256, 256))
    assert dw[2].all() and dg[2].all()
    assert (dg[0] - dw[0]).abs().max().item() <= 1e-2
    assert (dg[1] - dw[1]).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_step5_enhancer_on_the_card_matches_the_cpu(card):
    """The Step-5 enhancer (``face_enhance=False``, the default composite,
    RetinaFace cfg_mnet detecting) at a slim ParseNet, f32: within one gray
    level (at most 0.1% of subpixels off by more than 1, a mean difference
    under 0.01), a face in every frame."""
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.pipeline.enhance import FaceEnhancer, reference_enhancer_hook

    retina = _retinaface("mnet")
    torch.manual_seed(10)
    parsenet = ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=2)
    with torch.no_grad():  # the skin class everywhere: the whole crop is face
        parsenet.out_mask_conv.conv2d.bias[1] += 1.0
    frames = _frames(4, 256, 256, 11)
    out = {}
    for dev in ("cpu", card):
        enh = FaceEnhancer({"retinaface": retina, "parsenet": parsenet}, in_size=64,
                           dtype="float32", parse_size=128, device=dev)
        with torch.no_grad():
            _, _, valid = enh._detect(frames.to(dev).permute(0, 3, 1, 2).float())
        assert valid.all()
        out[str(dev)] = reference_enhancer_hook(enh)(frames).cpu()
    d = (out["cuda"].int() - out["cpu"].int()).abs().float()
    assert out["cuda"].shape == (4, 256, 256, 3) and out["cuda"].dtype == torch.uint8
    assert (d > 1).float().mean().item() <= 1e-3 and d.mean().item() < 0.01
    assert (out["cpu"] != frames).any()  # the crops went back through the masks


def _slim_tail(seed=12):
    """The slim mouth tail's modules: GFPGANv1Clean at out_size 64 with its
    ToRGB layers scaled by 0.25 (random weights would put part of the
    output outside [-1, 1], where the restored face is exact 0s and 255s
    and the uint8 truncation of their paste turns on the last f32 bit),
    RetinaFace cfg_mnet with its level-2 face logit raised, and a slim
    ParseNet with class 11 (255 in the mouth colormap) raised, so the
    mouth mask covers the boxes."""
    from s2v_torch.models.gfpgan import GFPGANv1Clean
    from s2v_torch.models.layers import ToRGB
    from s2v_torch.models.parsenet import ParseNet

    torch.manual_seed(seed)
    gfpgan = GFPGANv1Clean(out_size=64, num_style_feat=64, channel_multiplier=0.5, narrow=0.5)
    parsenet = ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=2)
    with torch.no_grad():
        for m in gfpgan.modules():
            if isinstance(m, ToRGB):
                m.modulated_conv.weight *= 0.25
                m.bias *= 0.25
        parsenet.out_mask_conv.conv2d.bias[11] += 1.0
    return dict(gfpgan=gfpgan.eval(), retinaface=_retinaface("mnet"), parsenet=parsenet.eval())


@pytest.mark.cuda
def test_gfpgan_clean_on_the_card_matches_the_cpu(card):
    """GFPGANv1Clean at out_size 64 (slim) and 128 (channel_multiplier 2,
    narrow 0.5), f32 without TF32: 1e-4 of the output's scale."""
    from s2v_torch.models.gfpgan import GFPGANv1Clean

    torch.manual_seed(13)
    for kw in (dict(out_size=64, num_style_feat=64, channel_multiplier=0.5, narrow=0.5),
               dict(out_size=128, num_style_feat=128, channel_multiplier=2, narrow=0.5,
                    num_mlp=4)):
        model = GFPGANv1Clean(**kw).eval()
        x = torch.rand(2, 3, kw["out_size"], kw["out_size"]) * 2 - 1
        with torch.no_grad():
            want = model(x)
            got = model.to(card)(x.to(card)).cpu()
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("with_landmarks", [False, True])
def test_mouth_hook_on_the_card_matches_the_cpu(card, with_landmarks):
    """The mouth hook at slim widths, f32, detecting (every face valid) and
    with landmarks5: within one gray level (at most 0.1% of subpixels off by
    more than 1, a mean difference under 0.01); the tail moved the boxes'
    pixels."""
    from s2v_torch.pipeline.restoration import make_mouth_restorer

    models = _slim_tail()
    frames = _frames(4, 96, 112, 14)
    boxes = np.tile(np.asarray([26, 18, 86, 80], np.float32), (4, 1))
    kw = {}
    if with_landmarks:
        rng = np.random.RandomState(15)
        kw["landmarks5"] = (np.asarray([[38, 40], [72, 40], [56, 56], [42, 70], [70, 70]],
                                       np.float32) + rng.randn(4, 5, 2).astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        hook = make_mouth_restorer(models, chunk=3, parse_size=128, dtype="float32",
                                   device=dev)
        if not with_landmarks:
            with torch.no_grad():
                _, _, valid = hook.restorer._detect(frames.to(dev).permute(0, 3, 1, 2).float())
            assert valid.all()
        out[str(dev)] = hook(frames, boxes, **kw).cpu()
    d = (out["cuda"].int() - out["cpu"].int()).abs().float()
    assert out["cuda"].shape == (4, 96, 112, 3) and out["cuda"].dtype == torch.uint8
    assert (d > 1).float().mean().item() <= 1e-3 and d.mean().item() < 0.01
    change = (out["cpu"][:, 18:80, 26:86].int() - frames[:, 18:80, 26:86].int()).abs()
    assert change.float().mean().item() > 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("hw,levels", [((512, 512), 10), ((256, 512), 9), ((96, 128), 6)])
def test_laplacian_pyramid_blend_on_the_card_matches_the_cpu(card, hw, levels):
    """The blend down to 1x1 (1x2 non-square), f32: within 1e-3 on 0..255."""
    from s2v_torch.pipeline.utils import laplacian_pyramid_blend

    g = torch.Generator().manual_seed(16)
    a, b = [torch.rand(2, 3, *hw, generator=g) * 255 for _ in range(2)]
    mask = torch.rand(2, 1, *hw, generator=g)
    want = laplacian_pyramid_blend(a, b, mask, levels)
    got = laplacian_pyramid_blend(a.to(card), b.to(card), mask.to(card), levels).cpu()
    assert got.shape == want.shape == (2, 3, *hw)
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_deferred_cache_writes_wait_for_their_pinned_copies(card, tmp_path):
    """``ArtifactCache(defer=True)`` on CUDA tensors queued behind a long
    run of work: the copies go to pinned memory without waiting, and flush()
    writes each file only after its copy is done, so the bytes are the
    tensors' final values."""
    from s2v_torch.utils.cache import ArtifactCache

    cache = ArtifactCache(str(tmp_path))
    x = torch.zeros(64, 1024, 1024, device=card)
    for _ in range(50):  # a few ms of queued work before the values are final
        x = x + 1.0
    frames = (x[:4, :256, :256, None] * 3).to(torch.uint8).expand(4, 256, 256, 3).contiguous()
    got = cache.get_or_compute("clip", "stabilized", lambda: frames, defer=True)
    both = cache.get_or_compute("clip", "both", lambda: {"a": x[0, :8, :8], "b": np.ones(3)},
                                defer=True)
    assert got is frames and both["a"].is_cuda
    host, events = cache._pending[0][1:]
    assert host.is_pinned() and len(events) == 1
    cache.flush()
    np.testing.assert_array_equal(np.load(tmp_path / "clip_stabilized.npz")["__single__"],
                                  np.full((4, 256, 256, 3), 150, np.uint8))
    data = np.load(tmp_path / "clip_both.npz")
    np.testing.assert_array_equal(data["a"], np.full((8, 8), 50, np.float32))
    np.testing.assert_array_equal(data["b"], np.ones(3))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [16, 80, 120])
def test_component_discriminator_on_the_card_matches_the_cpu(card, size):
    """GFPGAN's FacialComponentDiscriminator (K1 for its five activations,
    K3 for its two blurs; K2 and K3 again in backward) on the card against
    the CPU (plain versions), f32 without TF32, with the launches its sites
    imply: 5 K1 and 2 K3 forward, 5 K2 and 2 K3 backward. 16^2 crops take
    K3's one-thread-per-output kernel, 80^2 and 120^2 its strips (41 to 121
    output columns). The logits and both feature levels within 1e-4 of
    their scale. The gradients are held in norm, relative L2 error 5e-3:
    elementwise they jump where an activation lies within f32 rounding of 0
    (the leaky ReLU's slope is 1 or 0.2 by its sign), and at these sizes
    some do: on the CPU alone, f32 against f64 at 80^2, the input gradient
    differs by 1.2% of its largest entry and by 1.0e-3 in relative L2
    (conv1's weight gradient 1.2e-3); the card against the CPU by up to
    1.2% elementwise, with the kernels as with the plain versions on the
    card (which agree with the kernels within 1e-6 where no gate flips)."""
    from s2v_torch.train.gfpgan_train import FacialComponentDiscriminator

    torch.manual_seed(8)
    model = FacialComponentDiscriminator()
    x = torch.rand(3, 3, size, size) * 2 - 1
    w = torch.randn(3, 1, size // 4, size // 4)

    def run(module, xin, win):
        xin = xin.clone().requires_grad_(True)
        out, feats = module(xin, return_feats=True)
        (out * win).sum().backward()
        grads = [p.grad for p in module.parameters()]
        module.zero_grad(set_to_none=True)
        return [out, *feats], [xin.grad, *grads]

    want_out, want_grads = run(model, x, w)
    gpu = model.to(card)
    before = launch_counts()
    got_out, got_grads = run(gpu, x.to(card), w.to(card))
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fused_act": 5, "fused_act_bwd": 5,
                                                        "upfirdn2d": 4}
    for a, ref in zip(got_out, want_out):
        assert a.shape == ref.shape
        assert (a.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert len(got_grads) == len(want_grads)
    for a, ref in zip(got_grads, want_grads):
        assert a.shape == ref.shape
        assert (a.cpu() - ref).norm().item() <= 5e-3 * ref.norm().item()


GFPGANER = dict(input_is_latent=True, different_w=True)  # gfpgan/utils.py:63-74


@pytest.mark.cuda
@pytest.mark.parametrize("sft_half", [True, False])
def test_gfpgan_v1_on_the_card_matches_the_cpu(card, sft_half):
    """The original GFPGANv1 at out_size 64 (slim), its K1 and K3 sites on
    the kernels, f32 without TF32: 1e-4 of the output's scale; one forward
    launches ``forward_launches`` kernels."""
    from s2v_torch.models.gfpgan import GFPGANv1, forward_launches
    from s2v_torch.ops.kernels import reset_launch_counts

    torch.manual_seed(17)
    model = GFPGANv1(out_size=64, num_style_feat=64, channel_multiplier=0.5, narrow=0.5,
                     sft_half=sft_half, **GFPGANER).eval()
    x = torch.rand(2, 3, 64, 64) * 2 - 1
    with torch.no_grad():
        want, want_rgbs = model(x)
        model.to(card)
        reset_launch_counts()
        got, got_rgbs = model(x.to(card))
        counts = launch_counts()
    assert counts == forward_launches(model)
    for g, w in zip([got, *got_rgbs], [want, *want_rgbs]):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_affine_warp_shear_on_the_card_matches_the_cpu(card, inverse):
    """The approximate warp of a 4-channel 96x112 frame to a 512^2 crop
    (the mouth tail's geometry) and its inverse paste, f32: within 1e-3 on
    0..255 (its matmuls in full f32 on both)."""
    from s2v_torch.ops.warp import affine_warp_shear

    g = torch.Generator().manual_seed(18)
    t = np.deg2rad(-4.0)
    fwd = np.asarray([[[np.cos(t) * 5.3, -np.sin(t) * 5.3, -130.0],
                       [np.sin(t) * 5.3, np.cos(t) * 5.3, -90.0]]], np.float32)
    if inverse:
        src, out_hw = torch.rand(1, 4, 512, 512, generator=g) * 255, (96, 112)
    else:
        src, out_hw = torch.rand(1, 4, 96, 112, generator=g) * 255, (512, 512)
    mats = torch.from_numpy(fwd)
    want = affine_warp_shear(src, mats, out_hw, inverse=inverse)
    got = affine_warp_shear(src.to(card), mats.to(card), out_hw, inverse=inverse).cpu()
    assert got.shape == want.shape and want.abs().max().item() > 1.0
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_up_face_editor_on_the_card_matches_the_cpu(card):
    """The GANimation editor (ngf 64, 6 blocks, random weights) on two
    384^2 faces, full f32: within 1e-4 on 0..1."""
    from s2v_torch.models.ganimation import SplitGenerator
    from s2v_torch.pipeline.restoration import make_up_face_editor

    torch.manual_seed(19)
    faces = torch.rand(2, 3, 384, 384)
    out = {}
    for dev in ("cpu", card):
        hook = make_up_face_editor({"ganimation": SplitGenerator()}, "surprise", device=dev)
        torch.manual_seed(20)
        hook.generator.load_state_dict(SplitGenerator().state_dict())
        out[str(dev)] = hook(faces.to(dev)).cpu()
    assert out["cuda"].shape == faces.shape
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("approx_warp", [False, True])
def test_mouth_hook_with_gfpgan_v1_on_the_card_matches_the_cpu(card, approx_warp):
    """The slim mouth tail with the original GFPGANv1 (out_size 64, its
    ToRGB layers scaled by 0.04 as the CPU tests scale them), detecting,
    f32, exact or approximate warps: within one gray level (at most 0.1% of
    subpixels off by more than 1, a mean difference under 0.01); every
    face valid, the boxes' pixels moved."""
    from s2v_torch.models.gfpgan import GFPGANv1, ToRGBV1
    from s2v_torch.pipeline.restoration import make_mouth_restorer

    models = _slim_tail()
    torch.manual_seed(21)
    v1 = GFPGANv1(out_size=64, num_style_feat=64, channel_multiplier=0.5, narrow=0.5,
                  sft_half=True, **GFPGANER)
    with torch.no_grad():
        for m in v1.modules():
            if isinstance(m, ToRGBV1):
                m.modulated_conv.weight *= 0.04
                m.bias *= 0.04
    models["gfpgan"] = v1.eval()
    frames = _frames(4, 96, 112, 14)
    boxes = np.tile(np.asarray([26, 18, 86, 80], np.float32), (4, 1))
    out = {}
    for dev in ("cpu", card):
        hook = make_mouth_restorer(models, chunk=3, parse_size=128, dtype="float32",
                                   approx_warp=approx_warp, device=dev)
        with torch.no_grad():
            _, _, valid = hook.restorer._detect(frames.to(dev).permute(0, 3, 1, 2).float())
        assert valid.all()
        out[str(dev)] = hook(frames, boxes).cpu()
    d = (out["cuda"].int() - out["cpu"].int()).abs().float()
    assert (d > 1).float().mean().item() <= 1e-3 and d.mean().item() < 0.01
    change = (out["cpu"][:, 18:80, 26:86].int() - frames[:, 18:80, 26:86].int()).abs()
    assert change.float().mean().item() > 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False])
def test_full_generator_sr_on_the_card_matches_the_cpu(card, deterministic):
    """FullGeneratorSR 64 -> 256 (slim), its K1 and K3 sites on the kernels,
    f32 without TF32: within 1e-4 of the output's scale with zeros for the
    upper levels' features; with their noise drawn from a generator on the
    card, two draws from one seed agree within 1e-4 of scale (cuDNN's convs
    are not bit-reproducible from call to call) and differ from the
    zero-noise output. One forward launches ``kernel_sites`` kernels."""
    from s2v_torch.models.gpen import FullGeneratorSR
    from s2v_torch.ops.kernels import reset_launch_counts
    from s2v_torch.train.gan import kernel_sites

    torch.manual_seed(18)
    model = FullGeneratorSR(in_size=64, out_size=256, style_dim=64, n_mlp=2,
                            channel_multiplier=0.5, narrow=0.25).eval()
    with torch.no_grad():  # noise strengths start at 0: give the noise an effect
        for name, p in model.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.1)
    x = torch.rand(2, 3, 64, 64) * 2 - 1
    with torch.no_grad():
        want = model(x)
        model.to(card)
        reset_launch_counts()
        if deterministic:
            got = model(x.to(card))
        else:
            got = model(x.to(card), deterministic=False,
                        generator=torch.Generator(card).manual_seed(3))
            again = model(x.to(card), deterministic=False,
                          generator=torch.Generator(card).manual_seed(3))
            assert (got - again).abs().max().item() <= 1e-4 * max(1.0, got.abs().max().item())
        counts = launch_counts()
    k1, k3 = kernel_sites(model)
    calls = 1 if deterministic else 2
    assert counts == {"fused_act": calls * k1, "fused_act_bwd": 0, "upfirdn2d": calls * k3}
    if deterministic:
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    else:
        assert (got.cpu() - want).abs().max().item() > 1e-3  # the noise took effect


@pytest.mark.cuda
def test_tile_process_on_the_card_matches_the_cpu(card):
    """``tile_process`` over a slim RRDBNet x2 on a 70x50 frame, tile 32,
    pad 4, f32: within 1e-4 of the CPU."""
    from s2v_torch.models.rrdbnet import RRDBNet, tile_process

    torch.manual_seed(19)
    model = RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8).eval()
    x = torch.rand(1, 3, 70, 50)
    with torch.no_grad():
        want = tile_process(model, x, 2, tile_size=32, tile_pad=4)
        got = tile_process(model.to(card), x.to(card), 2, tile_size=32, tile_pad=4)
    assert got.shape == want.shape == (1, 3, 140, 100)
    assert (got.cpu() - want).abs().max().item() <= 1e-4
