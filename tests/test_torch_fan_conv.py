"""FAN's call inside the landmark sweep (``LipSyncPipeline.nets["fan"]``), on the
CPU: it runs under cuDNN's autotuner and in full f32 (TF32 off), restores
both flags after a call and after an exception, counts ``conv.timed.fan``
once a call, and leaves the CPU's landmarks bit for bit what the plain
call gives (the autotuner's flag does not reach the CPU's convolutions).
The card's side, the timed route against cuDNN's heuristic one, is
tests/test_torch_cuda.py ``test_fan_timed_route_on_the_card_matches_the_heuristic_route_and_the_cpu``.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from s2v_torch.device import full_f32
from s2v_torch.models import fan as t_fan
from s2v_torch.models import s3fd as t_s3fd
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import trace
from torch_parity import one_torch_thread

COUNTER = "conv.timed.fan"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


class FlagSpy(nn.Module):
    """Stands in for FAN: records the flags it runs under, returns
    heatmaps [B, 68, 64, 64] from a 1x1 convolution of the 4x4-pooled
    crops, and raises when ``fail`` is set."""

    def __init__(self, fail=False):
        super().__init__()
        self.conv = nn.Conv2d(3, 68, 1)
        self.fail = fail
        self.seen = []

    def forward(self, x):
        self.seen.append(dict(benchmark=torch.backends.cudnn.benchmark,
                              cudnn_tf32=torch.backends.cudnn.allow_tf32,
                              matmul_tf32=torch.backends.cuda.matmul.allow_tf32))
        if self.fail:
            raise RuntimeError("the FAN call failed")
        return self.conv(nn.functional.avg_pool2d(x, 4))


def pipeline(fan, s3fd=None):
    torch.manual_seed(3)
    if s3fd is None:
        s3fd = t_s3fd.S3FD()
        with torch.no_grad():  # random weights find a face in every frame
            s3fd.conv3_3_norm_mbox_conf.bias[3] += 2.0
    cfg = t_cfg.PipelineConfig(model=t_cfg.ModelConfig(dtype="float32"))
    return t_inf.LipSyncPipeline(cfg, t_inf.PipelineModels(s3fd=s3fd, fan=fan), device="cpu")


def frames(n, size=64, seed=5):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture
def flags():
    """The three flags, set to what they are not inside the FAN call, and
    restored after the test."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = False, True, True
    yield
    cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved


def current_flags():
    return (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_fan_call_runs_timed_in_full_f32_and_restores_the_flags(flags):
    spy = FlagSpy()
    pipe = pipeline(spy)
    x = torch.as_tensor(frames(3)).permute(0, 3, 1, 2).float()
    with torch.no_grad():
        pipe._sweep(pipe._landmarks, frames(3), 32)
        assert current_flags() == (False, True, True)
        with full_f32():
            pipe._landmarks(x)
    assert spy.seen == [dict(benchmark=True, cudnn_tf32=False, matmul_tf32=False)] * 2
    assert current_flags() == (False, True, True)


def test_fan_call_restores_the_flags_after_an_exception(flags):
    pipe = pipeline(FlagSpy(fail=True))
    with pytest.raises(RuntimeError, match="the FAN call failed"):
        pipe._sweep(pipe._landmarks, frames(2), 32)
    assert current_flags() == (False, True, True)
    torch.backends.cudnn.benchmark = True  # a caller that had it on keeps it on
    with pytest.raises(RuntimeError, match="the FAN call failed"):
        pipe._sweep(pipe._landmarks, frames(2), 32)
    assert current_flags() == (True, True, True)


def test_conv_timed_fan_counts_each_fan_call_of_a_sweep():
    """47 frames at batch 32: two FAN calls (32 and 15), as a dub request's
    reference faces' sweep makes them."""
    spy = FlagSpy()
    pipe = pipeline(spy)
    before = trace.counter(COUNTER)
    lms = pipe.extract_landmarks(frames(47), batch=32)
    assert lms.shape == (47, 68, 2)
    assert trace.counter(COUNTER) - before == 2
    assert len(spy.seen) == 2


@torch.no_grad()
def test_landmarks_on_the_cpu_are_bit_equal_to_the_plain_fan_call():
    """``_landmarks`` against its body with FAN called plainly, outside
    the autotuner's flag: boxes, validity and landmarks equal bit for bit.
    FAN with one hourglass module, S3FD at full width."""
    torch.manual_seed(9)
    fan = t_fan.FAN(num_modules=1)
    pipe = pipeline(fan)
    x = torch.as_tensor(frames(2, size=96, seed=8)).permute(0, 3, 1, 2).float()
    with full_f32():
        got = pipe._landmarks(x)
        boxes, valid = pipe._detect(x)
        centers, scales = t_fan.box_to_center_scale(boxes)
        hm = fan(t_fan.crop_faces_batched(x, centers, scales))
        want = boxes, valid, t_fan.heatmaps_to_landmarks(hm.float(), centers, scales)
    assert valid.all()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
