"""``synthesize`` with the mouth tail and the final hook against s2v_tpu's,
f32 on the CPU, on tests/test_torch_restoration.py's slim weights and
frames (the weights, the raised logits and the tolerance are explained
there), in the default configuration and under ``reuse_detections``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2v_torch.models.enet import ENet as TENet
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import config as t_cfg
from s2v_torch.utils import weights as TW
from s2v_tpu.pipeline.inference import LipSyncPipeline, PipelineModels
from s2v_tpu.utils.config import PipelineConfig, override
from test_torch_models import load
from test_torch_pipeline import ENET_KW, assert_close_frames, slice_inputs
from test_torch_restoration import (H, N, W, changed_in_boxes, jax_mouth, level2_face,
                                    port_mouth)
from test_torch_restoration import tail_weights  # noqa: F401 (a fixture)
from test_torch_step5 import assert_detects, jax_final, port_final, up2
from test_torch_step5 import weights as step5_weights  # noqa: F401 (a fixture)
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("reuse", [False, True])
def test_synthesize_with_the_mouth_tail_matches_jax(tail_weights, step5_weights,  # noqa: F811
                                                    monkeypatch, reuse):
    """Step 6 with the mouth tail and the final hook: in the default
    configuration both detect with RetinaFace (on the pasted frames and on
    their bilinear-2x frames), under reuse_detections both take the Step-1
    landmarks."""
    v = dict(step5_weights, **tail_weights)
    retina = level2_face(v["retinaface"])
    # the final stage keeps tests/test_torch_step5.py's ParseNet: with the
    # tail's, its face mask would cover the whole crop, and the random
    # GPEN's saturated output would land on integers (see ``unsaturated``)
    final_v = step5_weights
    x = slice_inputs(n=N)
    jcfg = override(PipelineConfig(), {"model.dtype": "float32", "infer.lnet_batch_size": 4,
                                       "model.reuse_detections": str(reuse).lower()})
    seen = {"mouth": [], "final": []}

    def recorded(hook, key):
        def run(frames, boxes, **kw):
            seen[key].append((np.asarray(frames), np.asarray(boxes)))
            return hook(frames, boxes, **kw)
        return run

    jmouth = jax_mouth(v, retina, monkeypatch)
    jpipe = LipSyncPipeline(jcfg, PipelineModels(
        enet=v["enet"], mouth_restorer=recorded(jmouth, "mouth"),
        final_enhancer=recorded(jax_final(final_v, retina), "final")))
    kw = dict(boxes_full=x["boxes"], lms_stab=x["lms_stab"],
              lms_full=x["lms_full"] if reuse else None)
    want = jpipe.synthesize(x["stab"], jnp.asarray(x["mel"]), x["frames"], x["coords"], 25.0,
                            **kw)
    tcfg = t_cfg.PipelineConfig(model=t_cfg.ModelConfig(dtype="float32", reuse_detections=reuse),
                                infer=t_cfg.InferenceConfig(lnet_batch_size=4))
    tpipe = t_inf.LipSyncPipeline(
        tcfg, t_inf.PipelineModels(enet=load(TENet(**ENET_KW), TW.enet_from_jax(v["enet"])),
                                   mouth_restorer=port_mouth(v, retina),
                                   final_enhancer=port_final(final_v, retina)),
        device="cpu")
    got = tpipe.synthesize(x["stab"], torch.from_numpy(x["mel"].copy()), x["frames"],
                           x["coords"], 25.0, **kw)
    pasted, boxes = (np.concatenate(t) for t in zip(*seen["mouth"]))
    tailed = np.concatenate([f for f, _ in seen["final"]])
    if not reuse:
        assert_detects(retina, pasted, [True] * len(pasted))
        assert_detects(retina, up2(tailed), [True] * len(tailed))
    assert want.shape == (len(pasted), 2 * H, 2 * W, 3)
    assert_close_frames(got, want)
    assert changed_in_boxes(tailed, pasted, boxes) > 5.0  # the tail ran
