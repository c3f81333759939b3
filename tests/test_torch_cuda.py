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
on the plain side). The ``s2v`` operators pass ``torch.library.opcheck``
on the card, and a slim GPEN exported with ``torch.export`` launches K1
and K3 from the loaded program, within 1e-5 of eager.
"""

import os
import subprocess
import sys

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


def _fan_full_width(seed=17):
    """2DFAN4 (4 modules, 256 features) with random weights and BatchNorm
    statistics that are not the identity."""
    from s2v_torch.models.fan import FAN

    torch.manual_seed(seed)
    fan = FAN(num_modules=4).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in fan.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.rand(n, generator=g) * 0.2 - 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.rand(n, generator=g) * 0.2 - 0.1)
    return fan


# FAN under cuDNN's heuristic choice of algorithms, in a process of its own:
# cuDNN keeps one plan per convolution shape in a process, whichever way it
# was chosen, so in the test's process the two routes would share plans
HEURISTIC_FAN = """
import sys, torch
from s2v_torch.device import full_f32
from s2v_torch.models.fan import FAN
state, crops, out = sys.argv[1:4]
fan = FAN(num_modules=4).eval()
fan.load_state_dict(torch.load(state))
fan = fan.cuda()
torch.backends.cudnn.benchmark = False
with torch.no_grad(), full_f32():
    torch.save([fan(c.cuda()).cpu() for c in torch.load(crops)], out)
"""


def _decode_margins(hm):
    """Per landmark of heatmaps [B, 68, h, w], the least change that could
    move its decode: the top-2 margin of the argmax and, at the argmax, the
    gaps between the neighbours that set the +-0.25 steps."""
    b, n, hh, ww = hm.shape
    flat = hm.flatten(2)
    top = flat.topk(2, dim=2)
    py, px = top.indices[..., 0] // ww, top.indices[..., 0] % ww

    def at(dy, dx):
        return flat.gather(2, ((py + dy).clamp(0, hh - 1) * ww
                               + (px + dx).clamp(0, ww - 1))[..., None])[..., 0]

    return (top.values[..., 0] - top.values[..., 1]).minimum(
        (at(0, 1) - at(0, -1)).abs()).minimum((at(1, 0) - at(-1, 0)).abs())


@pytest.mark.cuda
def test_fan_timed_route_on_the_card_matches_the_heuristic_route_and_the_cpu(card, tmp_path):
    """Full-width FAN at batches 32 and 18 on 256^2 crops through the
    pipeline's FAN call (``LipSyncPipeline.nets["fan"]``: cuDNN's autotuner, f32
    without TF32): once its plans are timed it runs no FFT kernel; its
    heatmaps lie within 1e-4 of their scale of cuDNN's heuristic route's
    and of the CPU's; and its landmarks decode equal to theirs wherever the
    decode's margin (``_decode_margins``) exceeds twice the measured
    difference (at least 95% of the landmarks)."""
    from s2v_torch.device import full_f32
    from s2v_torch.models.fan import heatmaps_to_landmarks
    from s2v_torch.pipeline.inference import LipSyncPipeline, PipelineModels
    from s2v_torch.utils.config import ModelConfig, PipelineConfig
    from torch.profiler import ProfilerActivity, profile

    fan = _fan_full_width()
    g = torch.Generator().manual_seed(19)
    crops = [torch.rand(b, 3, 256, 256, generator=g) for b in (32, 18)]
    torch.save(fan.state_dict(), tmp_path / "fan.pt")
    torch.save(crops, tmp_path / "crops.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", HEURISTIC_FAN, str(tmp_path / "fan.pt"),
                    str(tmp_path / "crops.pt"), str(tmp_path / "heuristic.pt")],
                   check=True, env=env, cwd=root, timeout=600)
    heuristic = torch.load(tmp_path / "heuristic.pt")
    with torch.no_grad():
        cpu = [fan(c) for c in crops]
    pipe = LipSyncPipeline(PipelineConfig(model=ModelConfig(dtype="float32")),
                           PipelineModels(fan=fan), device=card)
    with torch.no_grad(), full_f32():
        for c in crops:  # the autotuner's trials, FFT candidates among them
            pipe.nets["fan"](c.to(card))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timed = [pipe.nets["fan"](c.to(card)).cpu() for c in crops]
    kernels = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert not [k for k in kernels if "fft" in k.lower() or "cf32" in k], kernels
    centers = torch.full((1, 2), 128.0)
    scales = torch.full((1,), 1.28)
    for t, h, c in zip(timed, heuristic, cpu):
        got = heatmaps_to_landmarks(t, centers.expand(len(t), 2), scales.expand(len(t)))
        for want in (h, c):
            diff = (t - want).abs().max().item()
            assert diff <= 1e-4 * max(1.0, want.abs().max().item())
            held = _decode_margins(want) > 2 * diff
            assert held.float().mean().item() >= 0.95
            ref = heatmaps_to_landmarks(want, centers.expand(len(t), 2), scales.expand(len(t)))
            assert torch.equal(got[held], ref[held])


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


def grid_face_data(n=16, seed=0):
    """A face-sized height-field grid mesh with random BFM-shaped bases
    (80 / 64 / 80 columns), its point_buf from the mesh's own adjacency."""
    from s2v_torch.models.bfm import FaceModelData

    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:n, 0:n] / (n - 1.0) * 2 - 1
    z = 0.5 * np.sqrt(np.clip(1.2 - gx ** 2 - gy ** 2, 0, None))
    shape = np.stack([gx * 0.75, gy * 0.95, z], -1).reshape(-1, 3)
    shape -= shape.mean(0)
    quads = [(r * n + c, r * n + c + 1, (r + 1) * n + c, (r + 1) * n + c + 1)
             for r in range(n - 1) for c in range(n - 1)]
    faces = np.array([f for a, b, c, d in quads for f in ((a, c, b), (b, c, d))], np.int64)
    point_buf = np.full((n * n, 8), len(faces), np.int64)
    fill = np.zeros(n * n, np.int64)
    for i, f in enumerate(faces):
        for v in f:
            if fill[v] < 8:
                point_buf[v, fill[v]], fill[v] = i, fill[v] + 1
    n3 = 3 * n * n
    return FaceModelData(
        mean_shape=shape.reshape(-1).astype(np.float32),
        id_base=(rng.randn(n3, 80) * 0.02).astype(np.float32),
        exp_base=(rng.randn(n3, 64) * 0.02).astype(np.float32),
        mean_tex=(rng.rand(n3) * 100 + 120).astype(np.float32),
        tex_base=(rng.randn(n3, 80) * 5).astype(np.float32),
        face_buf=faces, point_buf=point_buf, keypoints=rng.choice(n * n, 68).astype(np.int64))


def rel_l2(got, want):
    got = torch.cat([g.detach().cpu().float().reshape(-1) for g in got])
    want = torch.cat([w.detach().cpu().float().reshape(-1) for w in want])
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("candidates", [None, 500], ids=["one_chunk", "chunks"])
def test_rasterize_on_the_card_matches_the_cpu(card, candidates, monkeypatch):
    """``rasterize`` on random meshes (faces spanning the image, some with a
    repeated vertex) and on the grid face at 224^2: the card's pass 1 is
    the CPU's arithmetic, so masks and images are equal (images within
    1e-5: the attribute sums' order); gradients within 1e-4 relative L2."""
    from s2v_torch.models import bfm
    from s2v_torch.models.bfm import ParametricFaceModel, rasterize

    if candidates is not None:
        monkeypatch.setattr(bfm, "CANDIDATES", candidates)
    rng = np.random.RandomState(21)
    verts = rng.randn(2, 30, 3).astype(np.float32)
    verts[..., 2] += 10
    cases = [(verts, rng.randint(0, 30, (40, 3)), rng.rand(2, 30, 3).astype(np.float32), 32)]
    fm = ParametricFaceModel(grid_face_data(), device="cpu")
    with torch.no_grad():
        v, _, color, _ = fm.compute_for_render(torch.from_numpy(
            rng.randn(2, 257).astype(np.float32) * 0.05))
    cases.append((v.numpy(), fm.face_buf.numpy(), color.numpy(), 224))
    for verts, faces, attrs, size in cases:
        outs = []
        for dev in (card, torch.device("cpu")):
            vt = torch.tensor(verts, device=dev, requires_grad=True)
            at = torch.tensor(attrs, device=dev, requires_grad=True)
            img, mask = rasterize(vt, faces, at, size)
            g = torch.from_numpy(np.random.RandomState(1).randn(*img.shape).astype(np.float32))
            (img * g.to(dev)).sum().backward()
            outs.append((img.detach().cpu(), mask.cpu(), vt.grad.cpu(), at.grad.cpu()))
        (ic, mc, vc, ac), (ip, mp, vp, ap) = outs
        assert mp.mean().item() > 0.05
        assert torch.equal(mc, mp)
        assert (ic - ip).abs().max().item() <= 1e-5
        assert rel_l2([vc, ac], [vp, ap]) <= 1e-4


@pytest.mark.cuda
def test_face3d_step_on_the_card_matches_the_cpu(card):
    """One slim ``make_face3d_train_step`` step (ReconNet (1, 1, 1, 1) x16,
    the grid face, batch 2 at 224^2, a channel-mean identity term) on the
    card and on the CPU from one state: metrics within 1e-4 relative, the
    clipped gradients within 1e-3 relative L2 and the running statistics
    within 1e-4 (f32 without TF32; cuDNN's and the CPU's conv orders)."""
    import copy

    from s2v_torch.models.bfm import ParametricFaceModel
    from s2v_torch.models.resnet import ReconNet
    from s2v_torch.train.face3d_train import make_face3d_train_step

    torch.manual_seed(22)
    recon = ReconNet(layers=(1, 1, 1, 1), base_planes=16)
    with torch.no_grad():
        for head in recon.final_layers:
            head.weight.mul_(0.1)
    rng = np.random.RandomState(23)
    data = grid_face_data()
    batch = {"image": rng.rand(2, 224, 224, 3).astype(np.float32),
             "gt_lm": (rng.rand(2, 68, 2) * 224).astype(np.float32),
             "mask": (rng.rand(2, 224, 224, 1) > 0.2).astype(np.float32)}

    def embed(x):
        m = torch.tanh(x.mean((1, 2)) * 3.0 - 1.0)
        return m / m.norm(dim=-1, keepdim=True)

    runs = []
    for dev in (card, torch.device("cpu")):
        init_fn, step_fn = make_face3d_train_step(
            ParametricFaceModel(data, device=dev), skin_mask=np.ones(256, np.float32),
            id_embed_fn=embed, device=dev)
        state = init_fn(recon=copy.deepcopy(recon))
        state, m = step_fn(state, batch)
        runs.append(({k: v.item() for k, v in m.items()},
                     [p.grad for p in state.module.parameters()],
                     [b for k, b in state.module.state_dict().items() if "running_" in k]))
    (mc, gc, sc), (mp, gp, sp) = runs
    for k in mp:
        assert abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]), k
    assert rel_l2(gc, gp) <= 1e-3
    assert all(rel_l2([a], [b]) <= 1e-4 for a, b in zip(sc, sp))


class TinyCritic(torch.nn.Module):
    """A SplitDiscriminator-shaped critic: two 4x4 stride-2 convs with
    LeakyReLU 0.01, a 3x3 score head and an AU head."""

    def __init__(self):
        super().__init__()
        self.main = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 4, 2, 1), torch.nn.LeakyReLU(0.01),
                                        torch.nn.Conv2d(8, 16, 4, 2, 1), torch.nn.LeakyReLU(0.01))
        self.dis_top = torch.nn.Conv2d(16, 1, 3, 1, 1, bias=False)
        self.aus_top = torch.nn.Conv2d(16, 17, 8, 1, bias=False)

    def forward(self, x):
        h = self.main(x)
        return self.dis_top(h), self.aus_top(h).flatten(1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["ganimation", "stargan"])
def test_expression_pair_on_the_card_matches_the_cpu(card, model):
    """One d_step (the interpolation weight drawn from one CPU generator
    seed on both) and one g_step of ``make_expression_trainer`` with a slim
    SplitGenerator at 32^2: metrics within 1e-4 relative, the critic's and
    the generator's gradients within 1e-3 relative L2."""
    import copy

    from s2v_torch.models.ganimation import SplitGenerator
    from s2v_torch.train.ganimation_train import make_expression_trainer

    torch.manual_seed(24)
    gen, critic = SplitGenerator(ngf=8, n_blocks=1), TinyCritic()
    rng = np.random.RandomState(25)
    src = (rng.rand(4, 3, 32, 32) * 2 - 1).astype(np.float32)
    aus = rng.rand(4, 17).astype(np.float32)
    runs = []
    for dev in (card, torch.device("cpu")):
        g, d = copy.deepcopy(gen), copy.deepcopy(critic)
        state, d_step, g_step = make_expression_trainer(g, d, model=model, device=dev)
        state, dm = d_step(state, src, aus, aus[::-1].copy(), torch.Generator().manual_seed(26))
        d_grads = [p.grad for p in d.parameters()]
        state, gm = g_step(state, src, aus, aus[::-1].copy())
        runs.append(({k: v.item() for k, v in {**dm, **gm}.items()}, d_grads,
                     [p.grad for p in g.parameters() if p.grad is not None]))
    (mc, dc, gc), (mp, dp, gp) = runs
    for k in mp:
        assert abs(mc[k] - mp[k]) <= 1e-4 * max(abs(mp[k]), 1e-6), k
    assert rel_l2(dc, dp) <= 1e-3 and rel_l2(gc, gp) <= 1e-3


@pytest.mark.cuda
def test_encodec_encoder_on_the_card_matches_the_cpu(card):
    """The full-width EnCodec encoder on 1 s of noise at 24 kHz, f32 without
    TF32 (``EncodecModel.encode`` runs under ``full_f32``): latents within
    1e-4 of their scale; the card's codes [1, 32, 75]."""
    import copy

    from s2v_torch.models.encodec import EncodecModel

    torch.manual_seed(27)
    model = EncodecModel().eval()
    x = torch.from_numpy(np.random.RandomState(28).randn(1, 1, 24000).astype(np.float32) * 0.3)
    with torch.no_grad():
        want = model.encoder(x)
        gpu = copy.deepcopy(model).to(card)
        got = gpu.encoder(x.to(card)).cpu()
        codes = gpu.encode(x.to(card))
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert codes.shape == (1, 32, 75)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_pass_opcheck_on_the_card(card, dtype):
    """The three ``s2v`` operators' CUDA implementations against their
    schemas and fake implementations (``torch.library.opcheck``: output
    shape, dtype and device, no input mutated), with K3 up, down and a crop."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(2, 8, 41, 37, generator=g, device=card).to(dtype)
    b = torch.randn(8, generator=g, device=card)
    out = torch.ops.s2v.fused_act_fwd(x, b, 0.2, 2 ** 0.5)
    fir = (blur_kernel([1, 3, 3, 1], 2)).ravel().tolist()
    for op, args in ((torch.ops.s2v.fused_act_fwd.default, (x, b, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.fused_act_bwd.default, (x, out, None, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.fused_act_bwd.default, (x, out, b, 0.2, 2 ** 0.5)),
                     (torch.ops.s2v.upfirdn2d.default, (x, fir, 4, 4, 2, 1, 2, 1, 2, 1)),
                     (torch.ops.s2v.upfirdn2d.default, (x, fir, 4, 4, 1, 2, 1, 1, -1, 2))):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
def test_exported_gpen_launches_its_kernels_on_the_card(card):
    """A slim GPEN generator exported on the card: the loaded program
    launches K1 and K3 once per site (``kernel_sites``) and gives the eager
    output within 1e-5 of its largest magnitude."""
    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.ops.kernels import reset_launch_counts
    from s2v_torch.train.gan import kernel_sites
    from s2v_torch.utils.export import export_program, load_exported

    torch.manual_seed(0)
    g = FullGenerator(size=64, style_dim=64, n_mlp=2, channel_multiplier=1,
                      narrow=0.25).to(card).eval()
    x = torch.rand(1, 3, 64, 64, device=card) * 2 - 1
    run = load_exported(export_program(g, (x,)))
    with torch.no_grad():
        want = g(x)
    reset_launch_counts()
    got = run(x)
    torch.cuda.synchronize()
    k1, k3 = kernel_sites(g)
    assert launch_counts() == {"fused_act": k1, "fused_act_bwd": 0, "upfirdn2d": k3}
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_final_stage_replays_its_one_frame_networks_bit_for_bit(card, monkeypatch):
    """The final stage (GPEN-BFR-2048, RealESRNet x2, RetinaFace-R50 and
    ParseNet at published widths, random weights, bf16 generators) over
    3 different 512^2 frames, twice, replayed as on the main path and all
    eager: every output frame equals the eager one bit for bit (a graph's
    output read after the next frame's replay would give that frame's
    pixels). RealESRNet, RetinaFace and ParseNet are captured once each, at
    their one shape, and replayed from then on; GPEN-2048 is declined and
    launches K1 and K3 as often as eager. Once captured, the stage makes the
    host wait for the card nowhere (CUDA's sync debug mode raises there)."""
    import collections

    from s2v_torch.models.gpen import FullGenerator
    from s2v_torch.models.parsenet import ParseNet
    from s2v_torch.models.rrdbnet import RRDBNet
    from s2v_torch.ops.kernels import reset_launch_counts
    from s2v_torch.pipeline.enhance import FaceEnhancer, final_enhancer_hook
    from s2v_torch.utils import trace

    torch.manual_seed(14)
    models = dict(retinaface=_retinaface("re50"), facegan=FullGenerator(size=2048).eval(),
                  parsenet=ParseNet().eval(),
                  srmodel=RRDBNet(scale=2, num_feat=32, num_block=23, num_grow_ch=32).eval())
    frames = _frames(3, 512, 512, 15).to(card)
    boxes = np.tile(np.asarray([[128, 128, 384, 384]], np.float32), (3, 1))

    def run(replayed):
        enh = FaceEnhancer(models, in_size=2048, dtype="bfloat16", parse_size=512, device=card)
        if not replayed:
            for net in enh.nets.values():
                monkeypatch.setattr(net, "_replay", lambda *a: None)
        passes = []
        for k in range(2):
            reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error" if replayed and k else "default")
            try:
                out = final_enhancer_hook(enh)(frames, boxes)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            passes.append((out.cpu(), launch_counts()))
        return enh, passes

    trace.reset()
    _, eager = run(False)
    assert not [r for r in trace.records() if r.name.startswith("graph.")]
    trace.reset()
    enh, replayed = run(True)
    records = trace.records()
    for (got, got_launches), (want, want_launches) in zip(replayed, eager):
        assert got.shape == (3, 1024, 1024, 3)
        assert all(torch.equal(got[i], want[i]) for i in range(3))
        assert got_launches == want_launches and got_launches["fused_act"] > 0
    assert sorted(r.tag for r in records if r.name == "graph.capture") == [
        "net.parsenet", "net.retinaface", "net.sr"]
    # each network's first call runs eagerly, the second captures and replays
    assert collections.Counter(r.tag for r in records if r.name == "graph.replay") == {
        "net.sr": 5, "net.retinaface": 5, "net.parsenet": 5}
    gpen = enh.nets["facegan"].replays[models["facegan"]]
    assert gpen.declined is True and not gpen.graphs
    trace.reset()
