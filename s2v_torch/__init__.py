"""s2v_torch: the PyTorch + CUDA port of s2v_tpu, for NVIDIA Hopper.

Imports ``torch`` and never ``jax`` or ``s2v_tpu``. Modules are NCHW
``nn.Module``s that keep the reference checkpoints' ``state_dict`` key
names; the public pipeline functions keep s2v_tpu's layout (NHWC uint8
frames, x1y1x2y2 boxes, 68-point landmarks). Entry points run on ``cuda``
and raise when no card is present unless the caller passes
``device="cpu"``.
"""
