"""The whole model with the ResNet-family and MobileNetV2 encoders: the port's
create_model against bts_tpu's with the same weights on the CPU in f32 (a
tiny ResNeXt and MobileNetV2), the weight bridge both ways, reference
checkpoints that carry the ResNet classifier, and every encoder of bts_tpu's
zoo accepted by the port's parser and create_model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import convert_state_dict
from bts_tpu_torch.config import Config, parse_args
from bts_tpu_torch.models import bts, create_model
from bts_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from bts_tpu_torch.training.checkpoint import load_checkpoint_dict

from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_zoo_helpers import H, W, ZOO, model_variables, tiny_resnets  # noqa: F401


def _cfgs(encoder, **kw):
    kw = dict(encoder=encoder, bts_size=128, fast_tail=False, lpg_impl="pallas", **kw)
    return Config(**kw), JConfig(**kw)


@pytest.mark.parametrize("encoder", ZOO)
def test_model_matches_bts_tpu(tiny_resnets, encoder):
    """All five outputs at rtol 1e-3, atol 1e-4, NYU focal scaling on a
    batch of two focals."""
    cfg, jcfg = _cfgs(encoder, dataset="nyu", max_depth=10.0)
    rng = np.random.default_rng(2)
    jmodel = jbts.create_model(jcfg)
    params, stats = model_variables(jmodel, rng)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    focal = np.array([518.8579, 721.5377], np.float32)
    want = jax.jit(lambda v, im, f: jmodel.apply(v, im, f))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(focal))

    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(focal))

    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("encoder", ZOO)
def test_state_dict_round_trips_through_bts_tpu_converter(tiny_resnets, encoder):
    """flax -> the port (state_dict_from_flax) -> flax (bts_tpu's
    convert_state_dict, strict) gives the same tree, bit for bit."""
    cfg, jcfg = _cfgs(encoder)
    params, stats = model_variables(jbts.create_model(jcfg), np.random.default_rng(3))
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)

    torch_state = {k: v.numpy() for k, v in model.state_dict().items()}
    params2, stats2 = convert_state_dict(torch_state, params, stats, strict=True)
    for a, b in [(params, params2), (stats, stats2)]:
        assert jax.tree.structure(a) == jax.tree.structure(b)
        jax.tree.map(np.testing.assert_array_equal, a, b)


def test_reference_resnet_checkpoint_with_fc_loads(tiny_resnets, tmp_path):
    """A reference trainer's save of a ResNet-family model: DDP-prefixed, with
    torchvision's classifier (fc), which the reference never calls. Both
    readers drop it; the rest loads strictly and bts_tpu's converter, which
    ignores it, builds the same flax tree from it."""
    cfg, jcfg = _cfgs("tiny_resnext_bts")
    model = bts.create_model(cfg)
    state = {"module." + k: v for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    state["module.encoder.base_model.fc.weight"] = torch.randn(1000, 2048, generator=gen)
    state["module.encoder.base_model.fc.bias"] = torch.randn(1000, generator=gen)
    path = tmp_path / "model-100"
    torch.save({"model": state, "global_step": 100}, path)

    for loaded in (load_checkpoint(str(path)), load_checkpoint_dict(str(path))["model"]):
        assert not any(".fc." in k for k in loaded)
        fresh = bts.create_model(cfg.replace(seed=1))
        fresh.load_state_dict(loaded, strict=True)
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)

    jmodel = jbts.create_model(jcfg)
    params, stats = model_variables(jmodel, np.random.default_rng(0))
    params2, _ = convert_state_dict({k: v.numpy() for k, v in state.items()}, params, stats,
                                    strict=True)
    want = state_dict_from_flax(params2, {})
    for k, v in want.items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)


@pytest.mark.parametrize("encoder", sorted(jbts.ENCODERS))
def test_every_bts_tpu_encoder_is_accepted(encoder):
    """parse_args and create_model (full width) take every encoder of
    bts_tpu's zoo, with that family's encoder and the registry's widths
    (test_torch_encoders.py runs each full-size encoder)."""
    cfg = parse_args(["--encoder", encoder, "--bts_size", "512"])
    assert cfg.encoder == encoder
    model = bts.create_model(cfg)
    family = {"densenet": "DenseNetEncoder", "resne": "ResNetEncoder",
              "mobilenet": "MobileNetV2Encoder"}
    assert [c for f, c in family.items() if f in encoder] == [type(model.encoder).__name__]
    assert bts.ENCODERS[encoder][1] == jbts.ENCODERS[encoder][1]


def test_unknown_encoder_raises():
    with pytest.raises(ValueError, match="unknown encoder 'resnet152_bts'"):
        parse_args(["--encoder", "resnet152_bts"])
    with pytest.raises(ValueError, match="unknown encoder"):
        create_model(Config(encoder="resnet152_bts"))
