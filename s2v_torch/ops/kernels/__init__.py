"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` lists every kernel wrapper; each keeps a plain integer
``launches`` count that rises by one per kernel launch (never for the plain
CPU version), so a run can show that it went through the kernels.
"""

from s2v_torch.ops.kernels.fused_act import (  # noqa: F401
    fused_bias_leaky_relu,
    fused_bias_leaky_relu_plain,
)
from s2v_torch.ops.kernels.upfirdn2d import upfirdn2d, upfirdn2d_plain  # noqa: F401

KERNELS = {"fused_act": fused_bias_leaky_relu, "upfirdn2d": upfirdn2d}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
