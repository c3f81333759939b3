"""The mouth tail's opt-in settings in ``synthesize`` against s2v_tpu's
``LipSyncPipeline``, f32 on the CPU, on tests/test_torch_infer_options.py's
slim weights, inputs and helpers: the original GFPGANv1 arch (out_size 64,
GFPGANer's wiring), detecting with RetinaFace on the pasted frames, and the
same with ``model.detector_dtype=bfloat16`` (RetinaFace's and ParseNet's
convs in bf16).

Tolerance as tests/test_torch_infer_options.py's, but for bf16: the two
packages' bf16 convolutions accumulate differently on the CPU (s2v_tpu
runs the whole detector in bf16, its softmax too, and rounds the best
anchors' scores to ties), so the port's bf16 output is held to s2v_tpu's
bf16 output within twice s2v_tpu's own bf16-vs-f32 difference on the same
inputs (mean, and share of subpixels off by more than 1), or the f32
tolerance where that is larger. On these weights s2v_tpu's own bf16 run
picks another anchor than its f32 run, so that bound is loose; RetinaFace's
decodes and ParseNet's bf16 logits and mouth mask, on the path the tail
runs them, are held tighter in tests/test_torch_detector_bf16.py.
"""

import numpy as np
import pytest

from test_torch_infer_options import assert_setting_matches, jax_synthesize, port_run
from test_torch_infer_options import weights  # noqa: F401 (a fixture)
from test_torch_restoration import tail_weights  # noqa: F401 (a fixture)
from test_torch_step5 import assert_detects
from test_torch_step5 import weights as step5_weights  # noqa: F401 (a fixture)
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_runs(weights):  # noqa: F811
    return jax_synthesize(weights, ["original_arch", "detector_bf16"])


def test_synthesize_with_the_original_arch_matches_jax(weights, jax_runs):  # noqa: F811
    assert_setting_matches(weights, jax_runs, "original_arch")


def test_synthesize_with_bf16_detectors_matches_jax(weights, jax_runs):  # noqa: F811
    """RetinaFace and ParseNet in bf16 on both sides: within twice s2v_tpu's
    own bf16-vs-f32 difference, or the f32 tolerance."""
    want, pasted = jax_runs["detector_bf16"]
    want32 = jax_runs["original_arch"][0]
    got, _ = port_run(weights, "detector_bf16")
    assert_detects(weights["retinaface"], pasted, [True] * len(pasted))
    gap = np.abs(want.astype(np.int32) - want32)
    d = np.abs(got.astype(np.int32) - want)
    print(f"bf16: port vs jax mean {d.mean():.4f}, >1 {(d > 1).mean():.5f}; "
          f"jax bf16 vs f32 mean {gap.mean():.4f}, >1 {(gap > 1).mean():.5f}")
    assert d.mean() <= max(2 * gap.mean(), 0.01)
    assert (d > 1).mean() <= max(2 * (gap > 1).mean(), 1e-3)
