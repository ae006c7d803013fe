"""Helpers shared by the ``test_torch_port_*`` files."""

import jax
import numpy as np


def random_tree(module, *args, seed=0, **kwargs):
    """A parameter tree of the flax ``module`` with random numpy values,
    shaped by ``jax.eval_shape`` (no init computation): lecun-scaled kernels,
    norm scales near 1, small nonzero biases and embeddings."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "embedding":
            return z / np.float32(np.sqrt(shape[-1]))
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(fill, shapes)
