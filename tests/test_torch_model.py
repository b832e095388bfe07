"""The whole slice: bts_tpu_torch create_model against bts_tpu's with the
same weights on the CPU in f32, and the state-dict bridge both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.config import Config
from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import convert_state_dict
from bts_tpu.models.encoders import densenet as jdensenet
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from bts_tpu_torch.models.encoders import densenet

from test_torch_decoder import randomize_bn

H, W = 64, 96
TINY = "tiny_densenet_bts"
TINY_CHANNELS = [16, 16, 16, 16, 32]


def tiny_jax(dtype=jnp.float32):
    return jdensenet.DenseNetEncoder((2, 2, 2, 2), 8, 16, dtype=dtype)


def tiny_torch():
    return densenet.DenseNetEncoder((2, 2, 2, 2), 8, 16)


@pytest.fixture
def tiny_encoder(monkeypatch):
    """The same narrow DenseNet under one name in both ENCODERS registries."""
    monkeypatch.setitem(jbts.ENCODERS, TINY, (tiny_jax, TINY_CHANNELS))
    monkeypatch.setitem(bts.ENCODERS, TINY, (tiny_torch, TINY_CHANNELS))
    return TINY


def jax_variables(cfg, rng):
    model = jbts.create_model(cfg)
    params, stats = jbts.init_model(model, jax.random.key(0), (1, H, W, 3))
    params, stats = randomize_bn(params, stats, rng)
    return model, params, stats


@pytest.mark.parametrize(
    "dataset,max_depth,dense_impl",
    [("nyu", 10.0, "auto"), ("kitti", 80.0, "auto"), ("nyu", 10.0, "taps")],
)
def test_model_matches_bts_tpu(tiny_encoder, dataset, max_depth, dense_impl):
    rng = np.random.default_rng(2)
    cfg = Config(
        encoder=tiny_encoder, dataset=dataset, max_depth=max_depth, bts_size=128,
        lpg_impl="pallas", fast_tail=False, compute_dtype="float32",
    )
    jmodel, params, stats = jax_variables(cfg, rng)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    focal = np.array([518.8579, 721.5377], np.float32)
    want = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(focal)
    )

    model = bts.create_model(cfg)
    assert model.encoder.dense_impl == "auto"
    model.encoder.dense_impl = dense_impl
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(focal))

    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-3, atol=1e-4
        )


def test_state_dict_round_trips_through_bts_tpu_converter(tiny_encoder):
    rng = np.random.default_rng(3)
    cfg = Config(encoder=tiny_encoder, bts_size=128, fast_tail=False)
    _, params, stats = jax_variables(cfg, rng)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)

    torch_state = {k: v.numpy() for k, v in model.state_dict().items()}
    params2, stats2 = convert_state_dict(torch_state, params, stats, strict=True)
    for a, b in [(params, params2), (stats, stats2)]:
        assert jax.tree.structure(a) == jax.tree.structure(b)
        jax.tree.map(np.testing.assert_array_equal, a, b)


def test_port_names_are_reference_names():
    state = bts.BTSModel("densenet161_bts").state_dict()
    for key in [
        "encoder.base_model.denseblock1.denselayer1.norm1.weight",
        "decoder.daspp_3.atrous_conv.aconv_sequence.1.weight",
        "decoder.reduc8x8.reduc.inter_128_64.0.weight",
        "decoder.reduc1x1.reduc.final.0.weight",
        "decoder.conv5.0.weight",
    ]:
        assert key in state


def test_unported_encoder_and_small_bts_size_raise():
    with pytest.raises(ValueError, match="unknown encoder 'resnet152_bts'"):
        bts.create_model(Config(encoder="resnet152_bts"))
    with pytest.raises(ValueError, match="bts_size"):
        bts.create_model(Config(encoder="densenet121_bts", bts_size=64))


def test_load_checkpoint_strips_ddp_prefix(tmp_path):
    """A reference trainer's save: {'model': DDP state dict, ...}."""
    model = bts.create_model(Config(encoder="densenet121_bts", bts_size=128))
    state = {"module." + k: v for k, v in model.state_dict().items()}
    path = tmp_path / "model.pth"
    torch.save({"model": state, "global_step": 3}, path)
    fresh = bts.create_model(Config(encoder="densenet121_bts", bts_size=128, seed=1))
    fresh.load_state_dict(load_checkpoint(str(path)), strict=True)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)
