"""Hand-written CUDA kernels of the port, each beside its plain version.

Each kernel launch adds one to its counter ``kernel.launch.<name>`` in
``s2v_torch.utils.trace`` (``COUNTERS``; never the plain CPU version), so a
run can show that it went through the kernels: ``fused_act`` K1,
``fused_act_bwd`` K2, ``upfirdn2d`` K3 (forward and backward launches
alike); ``launch_counts`` reads them. Each kernel is also an operator of the ``s2v`` namespace (``torch.ops.s2v.fused_act_fwd``,
``fused_act_bwd``, ``upfirdn2d``; ``_ops.py``), defined when this package
is imported, so ``torch.export`` keeps the kernels in an exported program.
"""

from s2v_torch.ops.kernels.fused_act import (  # noqa: F401
    fused_bias_leaky_relu,
    fused_bias_leaky_relu_bwd,
    fused_bias_leaky_relu_bwd_plain,
    fused_bias_leaky_relu_plain,
)
from s2v_torch.ops.kernels.upfirdn2d import upfirdn2d, upfirdn2d_plain  # noqa: F401
from s2v_torch.utils import trace

COUNTERS = {name: f"kernel.launch.{name}" for name in ("fused_act", "fused_act_bwd", "upfirdn2d")}


def reset_launch_counts() -> None:
    trace.reset(COUNTERS.values())


def launch_counts() -> dict:
    return {name: trace.counter(c) for name, c in COUNTERS.items()}
