"""One step of the port's ENet fine-tuning with the VGG16 perceptual term
and ReconNet's identity term against the JAX step's body, as
test_torch_finetune_step.py holds it (the two variants' JAX programs
compile in some 20 s each, so each has a file)."""

import pytest
from test_torch_finetune_step import check_finetune_step
from torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread for the module, its fixtures included
    (``torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def test_finetune_step_with_vgg_and_identity_matches_jax():
    check_finetune_step("vgg_id")
