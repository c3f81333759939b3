"""How the pipeline calls each network, read from the network's side: a
forward pre-hook on every module records the innermost ``net.*`` span open
at the call, the autocast state of the input's device, the TF32 flags and
cuDNN's autotuner flag, while the stages' public entry points
(``extract_landmarks``, ``extract_coeffs``, ``stabilize``,
``enhance_reference``, ``synthesize`` with the mouth tail, the final
enhancer and the ``--up_face`` editor) run slim modules on the CPU under
each setting of ``model.dtype`` and ``model.detector_dtype``.

The precision policies, as the CPU shows them (outside, both TF32 flags on
and the autotuner off):

- f32: no autocast, TF32 off;
- detector: TF32 off, bf16 autocast when ``model.detector_dtype`` is
  bfloat16, on the CPU too;
- generator: the TF32 flags as the caller left them, bf16 autocast only on
  a card (never here).

Only FAN runs under the autotuner. The replay rule
(``s2v_torch.pipeline.nets.replayed``) and the device-constant cache
(``s2v_torch.device.constant_on``) are tested on their own.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from s2v_torch.device import constant_on
from s2v_torch.models.dnet import DNet
from s2v_torch.models.enet import ENet
from s2v_torch.models.fan import FAN
from s2v_torch.models.ganimation import SplitGenerator
from s2v_torch.models.gfpgan import GFPGANv1Clean
from s2v_torch.models.gpen import FullGenerator
from s2v_torch.models.parsenet import ParseNet
from s2v_torch.models.resnet import ReconNet
from s2v_torch.models.retinaface import retinaface_mnet
from s2v_torch.models.rrdbnet import RRDBNet
from s2v_torch.models.s3fd import S3FD
from s2v_torch.pipeline import enhance, inference, nets, restoration
from s2v_torch.utils import config, trace
from torch_parity import fixed_landmarks, one_torch_thread

# (stage, network) -> (span, precision policy)
TABLE = {
    ("pipeline", "s3fd"): ("net.s3fd", "detector"),
    ("pipeline", "fan"): ("net.fan", "detector"),
    ("pipeline", "recon"): ("net.recon", "f32"),
    ("pipeline", "dnet"): ("net.dnet", "generator"),
    ("pipeline", "enet"): ("net.enet", "generator"),
    ("enhancer", "retinaface"): ("net.retinaface", "detector"),
    ("enhancer", "parsenet"): ("net.parsenet", "generator"),
    ("enhancer", "facegan"): ("net.gpen", "generator"),
    ("enhancer", "srmodel"): ("net.sr", "generator"),
    ("restorer", "retinaface"): ("net.retinaface", "detector"),
    ("restorer", "gfpgan"): ("net.gfpgan", "generator"),
    ("mouth", "parsenet"): ("net.parsenet", "detector"),
    ("editor", "ganimation"): ("net.ganimation", "f32"),
}
SETTINGS = [(d, det) for d in ("float32", "bfloat16") for det in ("float32", "bfloat16")]
PARSE_KW = dict(base_ch=16, max_ch=32, min_ch=8, res_depth=2)
N, H = 2, 96


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def slim_modules():
    torch.manual_seed(21)
    mods = {
        ("pipeline", "s3fd"): S3FD(),
        ("pipeline", "fan"): FAN(num_modules=1),
        ("pipeline", "recon"): ReconNet(layers=(1, 1, 1, 1), base_planes=8),
        ("pipeline", "dnet"): DNet(16, 8, 8, 32),
        ("pipeline", "enet"): ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
                                   lnet_base_nc=8, lnet_max_nc=32),
        ("enhancer", "retinaface"): retinaface_mnet(),
        ("enhancer", "parsenet"): ParseNet(**PARSE_KW),
        ("enhancer", "facegan"): FullGenerator(size=64, narrow=0.25, channel_multiplier=0.5,
                                               style_dim=64, n_mlp=2),
        ("enhancer", "srmodel"): RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8),
        ("restorer", "retinaface"): retinaface_mnet(),
        ("restorer", "gfpgan"): GFPGANv1Clean(out_size=64, num_style_feat=64,
                                              channel_multiplier=0.5, narrow=0.5),
        ("mouth", "parsenet"): ParseNet(**PARSE_KW),
        ("editor", "ganimation"): SplitGenerator(ngf=8),
    }
    with torch.no_grad():  # every stride-4 anchor scores a face: no frame is refused
        mods["pipeline", "s3fd"].conv3_3_norm_mbox_conf.bias[3] += 20.0
    return {k: m.eval() for k, m in mods.items()}


def observe(dtype: str, det_dtype: str):
    """Every network call of one slim run: [(stage, network, what it saw)]."""
    mods = slim_modules()
    calls = []

    def pre(module, args, key):
        dev = args[0].device.type
        on = torch.is_autocast_enabled(dev)
        calls.append((key, dict(
            t=time.perf_counter(), thread=threading.get_ident(),
            autocast=torch.get_autocast_dtype(dev) if on else None,
            tf32=(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32),
            benchmark=torch.backends.cudnn.benchmark)))

    for key, m in mods.items():
        m.register_forward_pre_hook(lambda module, args, key=key: pre(module, args, key))
    cfg = config.override(config.PipelineConfig(), {
        "model.dtype": dtype, "model.detector_dtype": det_dtype,
        "infer.without_rl1": "true", "infer.up_face": "surprise",
        "infer.lnet_batch_size": "4"})
    kw = dict(dtype=dtype, det_dtype=det_dtype, parse_size=64, device="cpu")
    stack = {k: mods["enhancer", k] for k in ("retinaface", "parsenet")}
    m = {n: mods["pipeline", n] for n in ("s3fd", "fan", "recon", "dnet", "enet")}
    models = inference.PipelineModels(
        **m, lm3d=np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                              [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float32),
        expression=(np.random.RandomState(55).randn(64) * 0.1).astype(np.float32),
        ref_enhancer=enhance.reference_enhancer_hook(enhance.FaceEnhancer(
            stack, in_size=64, **kw)),
        final_enhancer=enhance.final_enhancer_hook(enhance.FaceEnhancer(
            {**stack, "facegan": mods["enhancer", "facegan"],
             "srmodel": mods["enhancer", "srmodel"]}, in_size=64, **kw)),
        mouth_restorer=restoration.make_mouth_restorer(
            {"retinaface": mods["restorer", "retinaface"], "gfpgan": mods["restorer", "gfpgan"],
             "parsenet": mods["mouth", "parsenet"]}, chunk=4, **kw),
        up_face_editor=restoration.make_up_face_editor(
            {"ganimation": mods["editor", "ganimation"]}, "surprise", device="cpu"))
    pipe = inference.LipSyncPipeline(cfg, models, device="cpu")
    rng = np.random.RandomState(8)
    frames = (rng.rand(N, H, H, 3) * 255).astype(np.uint8)
    f256 = (rng.rand(N, 256, 256, 3) * 255).astype(np.uint8)
    lms = fixed_landmarks(N, 256, 256, seed=9)
    boxes = np.tile(np.asarray([[24, 24, 72, 72]], np.float32), (N, 1))

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = False, True, True
    trace.reset()
    try:
        pipe.extract_landmarks(f256)
        coeffs = pipe.extract_coeffs(f256, lms)
        stab = pipe.stabilize(f256, coeffs)
        enhanced, _ = pipe.enhance_reference(stab)
        pipe.synthesize(enhanced, torch.zeros(80, 22), frames, (8, 88, 8, 88), 25.0,
                        boxes_full=boxes, lms_stab=lms)
    finally:
        cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved
    nets = [r for r in trace.records() if r.name.startswith("net.")]
    out = []
    for key, seen in calls:
        around = [r for r in nets if r.thread == seen["thread"] and r.start <= seen["t"] <= r.end]
        seen["span"] = max(around, key=lambda r: r.start).name if around else None
        out.append((key, seen))
    return out


_OBSERVED = {}


def observed(dtype, det_dtype):
    if (dtype, det_dtype) not in _OBSERVED:
        _OBSERVED[dtype, det_dtype] = observe(dtype, det_dtype)
    return _OBSERVED[dtype, det_dtype]


@pytest.mark.parametrize("dtype, det_dtype", SETTINGS)
@pytest.mark.parametrize("stage, network", list(TABLE))
def test_each_network_is_called_in_its_span_and_precision(stage, network, dtype, det_dtype):
    span, policy = TABLE[stage, network]
    calls = [seen for key, seen in observed(dtype, det_dtype) if key == (stage, network)]
    assert calls, f"{stage}'s {network} was never called"
    bf16 = policy == "detector" and det_dtype == "bfloat16"
    want = dict(span=span, autocast=torch.bfloat16 if bf16 else None,
                tf32=(True, True) if policy == "generator" else (False, False),
                benchmark=network == "fan")
    for seen in calls:
        assert {k: seen[k] for k in want} == want


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("frames", [1, 4])
@pytest.mark.parametrize("stage, network", list(TABLE))
def test_only_the_enhancers_one_frame_calls_on_a_card_replay(stage, network, frames, device):
    want = stage == "enhancer" and frames == 1 and device == "cuda"
    assert nets.replayed(stage, network, torch.device(device), frames) is want


def test_the_table_is_the_one_this_file_holds_the_stages_to():
    assert {k: (f"net.{e.name}", e.precision) for k, e in nets.TABLE.items()} == TABLE
    assert [k for k, e in nets.TABLE.items() if e.timed] == [("pipeline", "fan")]


def test_constant_on_hands_back_one_tensor_per_values_device_and_dtype():
    cpu = torch.device("cpu")
    a = constant_on((104.0, 117.0, 123.0), cpu)
    assert constant_on((104.0, 117.0, 123.0), cpu) is a
    assert a.dtype == torch.float32 and a.tolist() == [104.0, 117.0, 123.0]
    b = constant_on((104.0, 117.0, 123.0), cpu, torch.float64)
    assert b is not a and b.dtype == torch.float64
    assert constant_on(((1, 2), (3, 4)), cpu).shape == (2, 2)


def test_stages_are_freed_without_the_cycle_collector():
    """A stage's nets hold no reference to the stage: a pipeline or hook
    that is dropped frees its modules at once (the fine-tune cell drops
    its Steps 1-3 pipeline before the window whose peak memory it reads)."""
    mods = slim_modules()
    gc.disable()
    try:
        pipe = inference.LipSyncPipeline(config.PipelineConfig(), inference.PipelineModels(
            s3fd=mods["pipeline", "s3fd"]), device="cpu")
        mouth = restoration.make_mouth_restorer(
            {"retinaface": mods["restorer", "retinaface"], "gfpgan": mods["restorer", "gfpgan"],
             "parsenet": mods["mouth", "parsenet"]}, device="cpu")
        final = enhance.FaceEnhancer({"parsenet": mods["enhancer", "parsenet"]}, device="cpu")
        editor = restoration.make_up_face_editor({"ganimation": mods["editor", "ganimation"]},
                                                 "surprise", device="cpu")
        stages = [weakref.ref(s) for s in (pipe, mouth, mouth.restorer, final, editor)]
        del pipe, mouth, final, editor
        assert [s() for s in stages] == [None] * len(stages)
    finally:
        gc.enable()
