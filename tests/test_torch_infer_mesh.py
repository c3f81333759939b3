"""``parallel.infer_mesh``: the port's frame-split pipeline on a mesh of CPU
replicas (s2v_torch.parallel.mesh.FrameMesh) against its own
single-device run and the JAX package's pipeline on its 8-virtual-device
CPU mesh (tests/test_pipeline_sharded.py), f32.

- Step 3 (``stabilize``, slim DNet) and Step 6 (``synthesize`` with the
  final hook: slim GPEN + RealESRNet x2 + ParseNet, detections reused) on 8
  frames, the port on a 4-entry mesh: every model stage's chunk is split in
  four (each module call sees 2 frames), and the output equals the port's
  single-device run and JAX's ``make_mesh(8, 1)`` run within one gray
  level (at most 0.1% of subpixels off by more than 1, mean under 0.01:
  f32 truncated to uint8, as tests/test_torch_pipeline.py states). Against
  the single-device run no subpixel is off by more than 1 (measured: 0.04%
  of them by 1; the CPU's convs sum in another order at batch 2 than at 8).
- The mouth tail (``make_mouth_restorer``, slim GFPGAN, RetinaFace
  detecting, and with landmarks) on a 2-entry mesh equals its
  single-device run to the same rule.

The ``infer`` command on a mesh: tests/test_torch_cli.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.models.dnet import DNet as TDNet
from s2v_torch.models.enet import ENet as TENet
from s2v_torch.models.gpen import FullGenerator as TGPEN
from s2v_torch.models.parsenet import ParseNet as TParseNet
from s2v_torch.models.rrdbnet import RRDBNet as TRRDBNet
from s2v_torch.parallel import mesh as TM
from s2v_torch.pipeline import enhance as t_enh
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.models import DNet, ENet
from s2v_tpu.models.gpen import FullGenerator
from s2v_tpu.models.parsenet import ParseNet
from s2v_tpu.models.rrdbnet import RRDBNet
from s2v_tpu.parallel.mesh import make_mesh
from s2v_tpu.pipeline.enhance import FaceEnhancer
from s2v_tpu.pipeline.inference import LipSyncPipeline, PipelineModels
from s2v_tpu.utils.config import PipelineConfig, override
from test_torch_pipeline import (ENET_KW, GPEN_KW, H, IN_SIZE, PARSE, PARSE_KW, RRDB_KW,
                                 W, assert_close_frames, slice_inputs)
from torch_parity import one_torch_thread, random_variables

N = 8
DNET_KW = dict(descriptor_nc=16, warp_base_nc=8, edit_base_nc=8, max_nc=32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _port(cls, kw, sd):
    m = cls(**kw)
    m.load_state_dict(sd)
    return m


def assert_same_run(got, want):
    """One gray level, and no subpixel off by more than 1."""
    assert_close_frames(got, want)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _counted(module, sizes):
    """Record the batch of every call of ``module``."""
    def hook(_, args):
        sizes.append(int(args[0].shape[0]))
    module.register_forward_pre_hook(hook)
    return module


@pytest.fixture(scope="module")
def slice_runs():
    x = slice_inputs(n=N, seconds=0.45)  # 8 mel chunks: one batch of 8 frames
    semantic = (np.random.RandomState(31).rand(N, 262).astype(np.float32) * 0.5 + 0.25)
    expression = np.zeros(64, np.float32)
    v = {
        "dnet": random_variables(DNet(**DNET_KW), (1, 256, 256, 3), (1, 26, 73), seed=10),
        "enet": random_variables(ENet(**ENET_KW), (1, 80, 16, 1), (1, 96, 96, 6),
                                 (1, 96, 96, 3), seed=11),
        "facegan": random_variables(FullGenerator(**GPEN_KW), (1, IN_SIZE, IN_SIZE, 3),
                                    seed=12, equalized=True),
        "parsenet": random_variables(ParseNet(**PARSE_KW), (1, PARSE, PARSE, 3), seed=13),
        "srmodel": random_variables(RRDBNet(**RRDB_KW), (1, 24, 24, 3), seed=14),
    }

    # the JAX package on its 8-device CPU mesh
    jmesh = make_mesh(8, 1)
    jcfg = override(PipelineConfig(), {"model.dtype": "float32",
                                       "model.reuse_detections": "true",
                                       "infer.lnet_batch_size": 8})
    jfinal = FaceEnhancer({"retinaface": None, "facegan": v["facegan"],
                           "parsenet": v["parsenet"], "srmodel": v["srmodel"]},
                          in_size=IN_SIZE, use_sr=True, sr_scale=2, dtype="float32",
                          parse_size=PARSE, mesh=jmesh)

    def jhook(frames, boxes_xyxy, **kw):
        return jfinal.process_batch(frames, face_enhance=True, possion_blending=True,
                                    bboxes=np.asarray(boxes_xyxy)[:, [1, 3, 0, 2]], **kw)

    jpipe = LipSyncPipeline(jcfg, PipelineModels(dnet=v["dnet"], enet=v["enet"],
                                                 expression=expression,
                                                 final_enhancer=jhook), mesh=jmesh)
    jstab = jpipe.stabilize(x["stab"], semantic, batch=8)
    want = jpipe.synthesize(x["stab"], jnp.asarray(x["mel"]), x["frames"], x["coords"],
                            25.0, boxes_full=x["boxes"], lms_full=x["lms_full"],
                            lms_stab=x["lms_stab"])

    # the port, single-device and on a 4-entry mesh of CPU replicas
    runs = {}
    for name, mesh in (("single", None), ("mesh", TM.make_mesh(devices=["cpu"] * 4))):
        sizes = {"dnet": [], "enet": [], "facegan": []}
        final = t_enh.FaceEnhancer(
            {"facegan": _counted(_port(TGPEN, GPEN_KW, TW.gpen_from_jax(v["facegan"])),
                                 sizes["facegan"]),
             "parsenet": _port(TParseNet, PARSE_KW, TW.parsenet_from_jax(v["parsenet"])),
             "srmodel": _port(TRRDBNet, RRDB_KW, TW.rrdbnet_from_jax(v["srmodel"]))},
            in_size=IN_SIZE, dtype="float32", parse_size=PARSE, device="cpu", mesh=mesh)
        tcfg = t_cfg.PipelineConfig(
            model=t_cfg.ModelConfig(dtype="float32", reuse_detections=True),
            infer=t_cfg.InferenceConfig(lnet_batch_size=8))
        models = t_inf.PipelineModels(
            dnet=_counted(_port(TDNet, DNET_KW, TW.dnet_from_jax(v["dnet"])), sizes["dnet"]),
            enet=_counted(_port(TENet, ENET_KW, TW.enet_from_jax(v["enet"])), sizes["enet"]),
            expression=expression, final_enhancer=t_enh.final_enhancer_hook(final))
        pipe = t_inf.LipSyncPipeline(tcfg, models, device="cpu", mesh=mesh)
        stab = pipe.stabilize(x["stab"], semantic, batch=8)
        out = pipe.synthesize(x["stab"], torch.from_numpy(x["mel"].copy()), x["frames"],
                              x["coords"], 25.0, boxes_full=x["boxes"], lms_full=x["lms_full"],
                              lms_stab=x["lms_stab"])
        runs[name] = dict(stab=stab, out=out, sizes=sizes)
    return dict(jax=dict(stab=np.asarray(jstab), out=want), **runs)


def test_stages_split_over_the_mesh(slice_runs):
    single, mesh = slice_runs["single"]["sizes"], slice_runs["mesh"]["sizes"]
    assert single == {"dnet": [8], "enet": [8], "facegan": [8]}
    assert mesh == {"dnet": [2] * 4, "enet": [2] * 4, "facegan": [2] * 4}


@pytest.mark.parametrize("stage", ["stab", "out"])
def test_mesh_run_equals_single_device_and_jax_mesh(slice_runs, stage):
    got = slice_runs["mesh"][stage]
    assert_same_run(got, slice_runs["single"][stage])
    assert_close_frames(got, slice_runs["jax"][stage])
    if stage == "out":
        assert got.shape == (N, 2 * H, 2 * W, 3)


def test_mouth_tail_on_a_mesh_equals_single_device():
    from s2v_torch.models.gfpgan import GFPGANv1Clean
    from s2v_torch.models.retinaface import RetinaFace
    from s2v_torch.pipeline.restoration import make_mouth_restorer

    torch.manual_seed(3)
    mods = dict(retinaface=RetinaFace(out_channel=64, backbone="mobilenet0.25"),
                gfpgan=GFPGANv1Clean(out_size=64, num_style_feat=64, channel_multiplier=0.5,
                                     narrow=0.5),
                parsenet=TParseNet(**PARSE_KW))
    frames = (np.random.RandomState(5).rand(4, H, W, 3) * 255).astype(np.uint8)
    boxes = np.tile(np.asarray([20, 10, 90, 80], np.float32), (4, 1))
    lms = np.tile(np.asarray([[40, 35], [70, 35], [55, 50], [43, 65], [67, 65]], np.float32),
                  (4, 1, 1))
    outs = {}
    for name, mesh in (("single", None), ("mesh", TM.make_mesh(devices=["cpu"] * 2))):
        hook = make_mouth_restorer(mods, chunk=2, parse_size=PARSE, dtype="float32",
                                   device="cpu", mesh=mesh)
        outs[name] = (hook(frames, boxes).numpy(), hook(frames, boxes, landmarks5=lms).numpy())
    for a, b in zip(outs["mesh"], outs["single"]):
        assert_same_run(a, b)
