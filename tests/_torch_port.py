"""Shared helpers of the PyTorch port's tests (tests/test_torch_port_*.py):
JAX parameter trees redrawn from a numpy seed, carried into a port module
with params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np

from unitspeech_tpu_torch.utils.params import params_from_jax


def randomize(tree, seed):
    """Redraw every parameter leaf from a numpy seed, by leaf name. The JAX
    init zeroes the rezero gates and the unconditional embeddings, which
    would hide whole branches from a comparison."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = x.shape
        if name in ("scale", "gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "g":
            v = rng.uniform(0.3, 0.6, shape)
        elif name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.2 * rng.standard_normal(shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def scale_gates(tree, factor):
    """Multiply the rezero gates `g` of a parameter tree by `factor`. With
    random weights the sampler state grows ~100x over the reverse process
    and each linear attention squares its input, so a sampler run takes
    small gates (as utils/params.random_params draws them)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * factor if str(getattr(p[-1], "key", "")) == "g" else x,
        jax.device_get(tree))


def load(module, jparams):
    """Load a JAX parameter tree into a port module; eval mode."""
    module.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return module.eval()


def mask(t, lens):
    """(B, t) prefix mask for the lengths `lens`."""
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
