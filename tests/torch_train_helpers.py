"""Helpers shared by the port's training tests: both packages' Configs
with the same fields, and seeded variables of the tiny DenseNet-BTS that
tests/test_torch_model.py registers."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import flax_path_to_torch_key
from bts_tpu_torch.config import Config

from test_torch_decoder import randomize_bn

H, W = 64, 96


def cfgs(**kw):
    """The same fields for both packages' Configs."""
    return Config(**kw), JConfig(**kw)


_VARIABLES = {}  # seed -> the tiny model's (params, batch_stats), as numpy


def tiny_variables(tiny_encoder, jcfg, seed=0):
    """bts_tpu's model for ``jcfg`` and seeded variables of the tiny
    architecture (initialised once per seed in this process)."""
    jmodel = jbts.create_model(jcfg)
    if seed not in _VARIABLES:
        init_cfg = JConfig(encoder=tiny_encoder, bts_size=128, fast_tail=False)
        params, stats = jbts.init_model(jbts.create_model(init_cfg), jax.random.key(seed),
                                        (1, H, W, 3))
        _VARIABLES[seed] = randomize_bn(params, stats, np.random.default_rng(seed))
    params, stats = _VARIABLES[seed]
    copy = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    return jmodel, copy(params), copy(stats)


def to_flax(named, template):
    """A dict of torch-named arrays -> a tree shaped like ``template``."""

    def key(path, leaf):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        arr = np.asarray(named[flax_path_to_torch_key(keys, np.shape(leaf))])
        return jnp.asarray(arr.transpose(2, 3, 1, 0) if keys[-1] == "kernel" else arr)

    return jax.tree_util.tree_map_with_path(key, template)


def named_leaves(tree):
    """The non-masked leaves of an optax state tree by torch name (a conv
    bias named by its kernel's shape, as the TF graph's reduc convs need),
    as numpy in torch's layout."""
    leaves = {tuple(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
              if not isinstance(leaf, optax.MaskedNode)}
    out = {}
    for keys, leaf in leaves.items():
        arr = np.asarray(leaf)
        kernel = leaves.get(keys[:-1] + ("kernel",), leaf)
        out[flax_path_to_torch_key(keys, np.shape(kernel))] = (
            arr.transpose(3, 2, 0, 1) if keys[-1] == "kernel" else arr)
    return out
