"""The JAX package's model variables drawn with numpy at flax's initial
distributions, for tests that only need both packages on the same
weights.

``segtpu.models.unet.create_model_state`` compiles the model's whole
init program, 10–20 s of the CPU for each configuration; here the
variables' shapes come from tracing it (``jax.eval_shape``, no compile)
and every leaf is drawn: kernels from flax's default ``lecun_normal``
(a normal truncated at two standard deviations, scaled to variance
1/fan_in), biases zero, BatchNorm scales one, running means zero and
running variances one.
"""

import math

import jax
import numpy as np

from segtpu.models.unet import create_model_state


def _leaf(r, name, shape):
    if name == "kernel":
        fan_in = math.prod(shape[:-1])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = r.standard_normal(shape)
        while (bad := np.abs(w) > 2.0).any():
            w[bad] = r.standard_normal(int(bad.sum()))
        return (w * std).astype(np.float32)
    if name in ("scale", "var"):
        return np.ones(shape, np.float32)
    return np.zeros(shape, np.float32)


def drawn_variables(model, seed: int, input_shape=(1, 32, 32, 1)):
    """(params, batch_stats) of the JAX ``model`` as numpy trees, drawn
    from ``seed``."""
    shapes = jax.eval_shape(
        lambda k: create_model_state(model, k, input_shape),
        jax.random.key(0))
    r = np.random.default_rng(seed)
    draw = lambda path, a: _leaf(r, path[-1].key, a.shape)
    return tuple(jax.tree_util.tree_map_with_path(draw, t) for t in shapes)
