"""One step of the port's ENet fine-tuning with the VGG16 perceptual term
and ReconNet's identity term against the JAX step's body, as
test_torch_finetune_step.py holds it (the two variants' JAX programs
compile in some 20 s each, so each has a file)."""

from test_torch_finetune_step import check_finetune_step


def test_finetune_step_with_vgg_and_identity_matches_jax():
    check_finetune_step("vgg_id")
