"""Shared inputs of the LM parity tests (``tests/test_torch_lm_*.py``):
JAX LM params made from numpy draws in the JAX package's own tree
(``jax.eval_shape`` of its ``init``, so no JAX random draws are compiled),
carried into the port by ``lm_params_from_jax``, and the configs both
packages build."""
import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_jax

#: the dense family's archs
DENSE = ("yi-34b", "phi3-mini-3.8b", "minitron-8b", "command-r-35b")


def configs(arch, **over):
    """(the JAX config, the port's): the arch's smoke variant with
    ``over``."""
    return (jax_reduced(jax_get_config(arch), **over),
            reduced(get_config(arch), **over))


def jax_params(jcfg, seed=0):
    """Numpy params in the JAX model's tree: dense ``w`` ~ N(0, 1/d_in),
    embeddings N(0, 1), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)
    (nonzero, so every leaf matters)."""
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.normal(size=s.shape)
        if "scale" in name:
            x = 1.0 + 0.1 * x
        elif "'b'" in name:
            x = 0.1 * x
        elif "'w'" in name:
            x = x / np.sqrt(s.shape[-2])
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_params(jcfg, seed=0):
    """(JAX numpy params, the port's tensors on the CPU)."""
    jp = jax_params(jcfg, seed)
    return jp, lm_params_from_jax(jp)
