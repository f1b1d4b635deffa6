"""Shared set-up of the port's parity tests: the reference's smoke model
with fp32 weights, and the same weights loaded into the port."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_smoke as jax_get_smoke
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke
from repro_torch.models.convert import params_from_numpy


def reference_model(seed: int = 0, arch: str = "qwen2-1.5b"):
    """(cfg, model, fp32 params) of the reference's smoke config of
    ``arch``, as its own serving tests make them."""
    cfg = jax_get_smoke(arch)
    model = jax_build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init_params(jax.random.key(seed)))
    return cfg, model, params


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_model(params, arch: str = "qwen2-1.5b"):
    """The port's LM on the CPU, holding the reference's weights."""
    return params_from_numpy(numpy_tree(params), get_smoke(arch),
                             device="cpu")
