"""Helpers shared by the port's tests of the ResNet, ResNeXt and MobileNetV2
encoders: small members of each family registered under one name in both
packages' ENCODERS, and seeded variables drawn with numpy (no jitted flax
init, which costs seconds a model on the CPU)."""

import jax
import numpy as np
import pytest

from bts_tpu.models import bts as jbts
from bts_tpu.models.encoders import resnet as jresnet
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.encoders import resnet

from test_torch_decoder import randomize_bn

H, W = 64, 96
RESNET_CHANNELS = [64, 256, 512, 1024, 2048]
TINY_LAYERS = (1, 1, 1, 1)
# name -> (groups, base_width): a one-block-a-layer member of each setting.
TINY_RESNETS = {
    "tiny_resnet_bts": (1, 64),
    "tiny_resnext_bts": (32, 4),
    "tiny_resnext32x8_bts": (32, 8),
}
# The model-level tests: a tiny ResNeXt, and MobileNetV2 whole (it is small).
ZOO = ("tiny_resnext_bts", "mobilenetv2_bts")


def jax_tiny_resnet(groups, base_width):
    def factory(dtype=jax.numpy.float32):
        return jresnet.ResNetEncoder(TINY_LAYERS, groups=groups, base_width=base_width,
                                     dtype=dtype)

    return factory


def torch_tiny_resnet(groups, base_width):
    return lambda: resnet.ResNetEncoder(TINY_LAYERS, groups=groups, base_width=base_width)


@pytest.fixture
def tiny_resnets(monkeypatch):
    """Every TINY_RESNETS entry in both ENCODERS registries."""
    for name, (groups, width) in TINY_RESNETS.items():
        monkeypatch.setitem(jbts.ENCODERS, name, (jax_tiny_resnet(groups, width),
                                                  RESNET_CHANNELS))
        monkeypatch.setitem(bts.ENCODERS, name, (torch_tiny_resnet(groups, width),
                                                 RESNET_CHANNELS))
    return TINY_RESNETS


_INIT = {"bias": np.zeros, "scale": np.ones, "mean": np.zeros, "var": np.ones}


def seeded_variables(init_fn, rng):
    """(params, batch_stats) of the shapes ``jax.eval_shape(init_fn)`` gives,
    as numpy: Xavier-uniform kernels (fans of the grouped kernel, as flax's
    init) drawn from ``rng``, then every BN away from its init
    (``randomize_bn``)."""
    shapes = jax.eval_shape(init_fn)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name != "kernel":
            return _INIT[name](leaf.shape, np.float32)
        kh, kw, ci, co = leaf.shape
        bound = np.sqrt(6.0 / ((ci + co) * kh * kw))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {}))
    return randomize_bn(params, stats, rng)


def model_variables(jmodel, rng, batch=1):
    """Seeded variables of a bts_tpu BTSModel at H x W."""
    x = jax.numpy.zeros((batch, H, W, 3))
    focal = jax.numpy.full((batch,), 518.8579)
    return seeded_variables(lambda: jmodel.init(jax.random.key(0), x, focal), rng)
