"""The port's ``train`` command as a whole on the CPU:
``s2v_torch.cli.main(["train", ...], device="cpu")`` on a directory of
reference-format files written from seeded port modules (S3FD, FAN and
VGG16 at their fixed widths; ReconNet, DNet and ENet slim, their geometry
read back from the files) and a 4-frame clip: Steps 1-3, the batches, the
fine-tune with the VGG16 perceptual and ReconNet identity terms, the log
and the checkpoints.

s2v_tpu's train command builds ENet at production width
(``make_enet_finetune_step``), so it cannot run on these slim files: this
test holds the composition (the number of steps, the log, a checkpoint that
``TrainCheckpointer.restore`` reads back bit for bit, only ``style_convs.*``
changed), and test_torch_finetune{,_step,_vgg_step}.py hold the numbers of
each piece against s2v_tpu.
"""

import json
import os

import numpy as np
import pytest
import torch

from s2v_torch import cli as t_cli
from s2v_torch.models.dnet import DNet
from s2v_torch.models.enet import ENet, enet_arch
from s2v_torch.models.fan import FAN
from s2v_torch.models.resnet import ReconNet
from s2v_torch.models.s3fd import S3FD
from s2v_torch.models.vgg import VGG16Features
from s2v_torch.train import finetune as TF
from s2v_torch.utils.checkpoint import TrainCheckpointer
from s2v_torch.utils.weights import load_reference, load_torch_checkpoint, merge_enet_lnet
from test_torch_cli import LM3D, write_wav
from torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def enet_from_files(root):
    sd = merge_enet_lnet(load_torch_checkpoint(os.path.join(root, "ENet.pth")),
                         load_torch_checkpoint(os.path.join(root, "LNet.pth")))
    return load_reference(enet_arch(sd), sd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("train")
    torch.manual_seed(0)
    mods = dict(s3fd=S3FD(), fan=FAN(), recon=ReconNet(layers=(1, 1, 1, 1), base_planes=8),
                dnet=DNet(16, 8, 8, 32),
                enet=ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
                          lnet_base_nc=8, lnet_max_nc=32),
                vgg16=VGG16Features())
    with torch.no_grad():  # random S3FD weights find no face: raise its face class
        mods["s3fd"].conv3_3_norm_mbox_conf.bias[3] += 2.0
    expression = (np.random.RandomState(55).randn(64) * 0.1).astype(np.float32)
    root = t_cli.write_checkpoint_dir(str(work / "ckpt"), mods, lm3d=LM3D,
                                      expression=expression)
    rng = np.random.RandomState(41)
    yy, xx = np.mgrid[0:192, 0:192]
    base = np.stack([xx * 255.0 / 192, yy * 255.0 / 192, (xx + yy) * 127.0 / 384], -1)
    frames = np.clip(base[None] + rng.randn(4, 192, 192, 3) * 30, 0, 255).astype(np.uint8)
    np.savez(work / "clip.npz", frames=frames, fps=25.0)
    audio = write_wav(work / "speech.wav", 200, n=4800)
    tmp = str(work / "tmp")
    state = t_cli.main(["train", "--face", str(work / "clip.npz"), "--audio", audio,
                        "--checkpoint_dir", root, "--tmp_dir", tmp, "--model.dtype", "float32",
                        "--train.epochs", "2", "--train.batch_size", "2",
                        "--train.lr", "1e-3"], device="cpu")
    return state, root, tmp


def test_train_runs_every_step_and_logs_the_last(trained):
    state, _, tmp = trained
    assert state.step == 4  # 4 frames (4 mel chunks) in batches of 2, 2 epochs
    with open(os.path.join(tmp, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1]["step"] == 4
    assert {"loss", "l1", "perceptual", "id"} <= set(lines[-1])
    assert all(np.isfinite(lines[-1][k]) for k in ("loss", "l1", "perceptual", "id"))


def test_train_changes_only_the_style_convs(trained):
    state, root, _ = trained
    before = enet_from_files(root).state_dict()
    after = state.module.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed and all(k.startswith("style_convs.") for k in changed), changed


def test_train_checkpoint_restores_bit_for_bit(trained):
    state, root, tmp = trained
    ckpt = TrainCheckpointer(os.path.join(tmp, "enet_ckpt"))
    assert ckpt.steps() == [2, 4]  # one per epoch
    fresh = enet_from_files(root)
    restored = ckpt.restore(TF.init_state(fresh, TF.make_optimizer(1e-3, fresh,
                                                                   TF.style_conv_mask)))
    assert restored.step == 4
    after = state.module.state_dict()
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, after[k]), k


def test_train_refuses_without_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["train", "--checkpoint_dir", str(tmp_path)])
