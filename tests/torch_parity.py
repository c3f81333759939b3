"""Shared helper of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np
from flax import traverse_util

import jax
import jax.numpy as jnp


def random_variables(model, *shapes, seed=0, equalized=False):
    """Variables of ``model`` from shapes alone (jax.eval_shape: no init
    compile), filled with random values at working scales: weights
    N(0, 1/fan_in) (N(0, 1) for GPEN's equalized layers, which scale at run
    time), norm scales and modulation biases near 1, other biases, noise
    strengths and BN means near 0, BN variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          *[jnp.zeros(s) for s in shapes])
    flat = traverse_util.flatten_dict(tree)
    out = {}
    for k, s in flat.items():
        r = rng.randn(*s.shape).astype(np.float32)
        if k[-1] == "running_var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif k[-1] == "weight" and len(s.shape) >= 2:
            v = r if equalized else r / np.sqrt(np.prod(s.shape[:-1]))
        elif k[-1] == "weight" or (k[-1] == "bias" and "modulation" in k):
            v = 1.0 + 0.1 * r
        else:  # biases, act biases, noise strengths, BN means, constant input
            v = r if k[-1] == "constant_input" else 0.1 * r
        out[k] = np.asarray(v, np.float32)
    return traverse_util.unflatten_dict(out)
