"""Training with the ResNet-family and MobileNetV2 encoders against bts_tpu
on the CPU: set_misc freezing per family and per --fix_first_conv_block(s)
setting, and two train steps of a tiny ResNeXt and of MobileNetV2 against
bts_tpu's make_train_step and create_optimizer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import flax_path_to_torch_key
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.training import optim, state

from test_torch_train_step import _Float64Numpy
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import cfgs, named_leaves
from torch_zoo_helpers import H, W, ZOO, model_variables, tiny_resnets  # noqa: F401

FIX = {"none": {}, "block": {"fix_first_conv_block": True},
       "blocks": {"fix_first_conv_blocks": True}}
_SHAPES = {}  # encoder -> bts_tpu's parameter shapes at full width


def bts_tpu_labels(jcfg):
    """bts_tpu's optimizer label of every parameter, by torch name."""
    if jcfg.encoder not in _SHAPES:
        jmodel = jbts.create_model(jcfg)
        _SHAPES[jcfg.encoder] = jax.eval_shape(
            lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), jnp.ones((1,)))
        )["params"]
    shapes = _SHAPES[jcfg.encoder]
    labels = {}
    for path, label in jax.tree_util.tree_leaves_with_path(joptim.param_labels(shapes, jcfg)):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        leaf = shapes
        for k in keys:
            leaf = leaf[k]
        labels[flax_path_to_torch_key(keys, leaf.shape)] = label
    return labels


@pytest.mark.parametrize("fix", list(FIX))
@pytest.mark.parametrize("encoder", ["resnet50_bts", "resnext101_bts", "mobilenetv2_bts"])
def test_frozen_sets_match_bts_tpu(encoder, fix):
    """The port's labels equal bts_tpu's. ResNet family: the stem and every
    block's bn1/bn2/bn3 frozen, the downsample BN trainable, layer1's first
    block(s) frozen under --fix_first_conv_block(s); MobileNetV2: nothing."""
    cfg, jcfg = cfgs(encoder=encoder, bts_size=512, fast_tail=False, **FIX[fix])
    want = bts_tpu_labels(jcfg)
    model = bts.BTSModel(encoder)
    assert optim.param_labels(model, cfg) == want
    frozen = {n for n, v in want.items() if v == "frozen"}
    base = "encoder.base_model."
    if encoder == "mobilenetv2_bts":
        assert not frozen
    else:
        assert {base + "conv1.weight", base + "bn1.weight", base + "layer4.2.bn3.bias"} <= frozen
        assert base + "layer2.0.downsample.1.weight" not in frozen
        assert (base + "layer1.0.conv2.weight" in frozen) == (fix != "none")
        assert (base + "layer1.1.conv1.weight" in frozen) == (fix == "blocks")
    optim.create_optimizer(cfg, model, 10)
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == frozen


def _bts_tpu_steps(jcfg, params, stats, batches, float64):
    """bts_tpu's jitted train step, optimizer included, over ``batches``, in
    float64 or f32: (losses, every leaf after the last step by torch name, in
    the step's dtype)."""
    from bts_tpu.models import layers as jlayers

    jax.config.update("jax_enable_x64", float64)
    try:
        with pytest.MonkeyPatch.context() as patch:
            if float64:
                patch.setattr(jlayers, "jnp", _Float64Numpy())
                jcfg = dataclasses.replace(jcfg, compute_dtype="float64")
            dtype = jnp.float64 if float64 else jnp.float32
            cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
            params, stats = cast(params), cast(stats)
            tx, _ = joptim.create_optimizer(jcfg, params, 50)
            step = jax.jit(jstate.make_train_step(jbts.create_model(jcfg), tx, jcfg))
            st = jstate.create_train_state(params, stats, tx)
            losses = []
            for b in batches:
                st, metrics = step(st, cast(b))
                losses.append(float(metrics["loss"]))
            return losses, {**named_leaves(st.params), **named_leaves(st.batch_stats)}
    finally:
        jax.config.update("jax_enable_x64", False)


# encoder -> (float64, bn_no_track_stats, loss rtol, state rtol, state atol)
TRAIN_CASES = {
    "tiny_resnext_bts": (True, False, 1e-6, 1e-6, 1e-7),
    "mobilenetv2_bts": (False, True, 1e-5, 0.0, 1e-5),
}


@pytest.mark.parametrize("encoder", ZOO)
def test_train_step_matches_bts_tpu(tiny_resnets, encoder):
    """Two train steps against bts_tpu's jitted step and optimizer: the
    losses, and every parameter and BN statistic after the two steps.

    The tiny ResNeXt with BN in train mode (the recipe's), both sides in
    float64: the losses at rtol 1e-6 (both packages take the silog loss as
    an f32 scalar, whatever the model's dtype), the state at rtol 1e-6, atol
    1e-7: a parameter moves by about lr = 1e-4 a step, so this holds each
    update to 1e-3 of itself, and through Adam's eps the gradients too (the
    f32 loss's rounding, carried back through sums that cancel, moves a
    parameter by up to 3.5e-8, and step 2's batch statistics by 1.3e-7 of
    themselves). Not in f32: there this gradient is ill-conditioned at this
    size, the post-conv BNs of the ResNet blocks normalising over 48 and 12
    values a channel (4x6 and 2x3 maps, batch 2); either package's f32
    gradient is off its float64 one by 3e-2 to 8e-2 of a leaf's largest
    magnitude, in different leaves.

    MobileNetV2 in f32 under --bn_no_track_stats (BN in eval mode, where f32
    is well-conditioned), at tests/test_torch_train_step.py's tolerances:
    the losses at rtol 1e-5, the state at atol 1e-5. Its float64 step costs
    minutes of XLA on a loaded CPU; its train-mode f32 step is held to a
    float64 one on the card by chip_smoke.py phase 9(c).

    The frozen set is set_misc's."""
    float64, no_track, loss_rtol, rtol, atol = TRAIN_CASES[encoder]
    kw = dict(encoder=encoder, dataset="nyu", max_depth=10.0, bts_size=128, fast_tail=False,
              lpg_impl="pallas", learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3,
              batch_size=2, input_height=H, input_width=W, bn_no_track_stats=no_track)
    cfg, jcfg = cfgs(**kw)
    params, stats = model_variables(jbts.create_model(jcfg), np.random.default_rng(3))
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(2, H, W, 3)).astype(np.float32),
                "depth": rng.uniform(0.0, 10.0, (2, H, W, 1)).astype(np.float32),
                "focal": np.array([518.8579, 518.8579], np.float32)} for _ in range(2)]
    want_losses, want = _bts_tpu_steps(jcfg, params, stats, batches, float64)

    dtype = torch.float64 if float64 else torch.float32
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    model.to(dtype)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg)
    for b, want_loss in zip(batches, want_losses, strict=True):
        got = step(st, {k: torch.from_numpy(v).to(dtype) for k, v in b.items()})
        np.testing.assert_allclose(got.item(), want_loss, rtol=loss_rtol)
    got = model.state_dict()
    assert want.keys() == {n for n in got if not n.endswith("num_batches_tracked")}
    for n, w in want.items():
        assert got[n].dtype == dtype and w.dtype == np.dtype(str(dtype).removeprefix("torch."))
        np.testing.assert_allclose(got[n].numpy(), w, rtol=rtol, atol=atol, err_msg=n)
    moved = [n for n in want if n.endswith("running_mean")
             and not np.array_equal(want[n], state_dict_from_flax(params, stats)[n].numpy())]
    assert bool(moved) == (not no_track)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    if encoder == "mobilenetv2_bts":
        assert not frozen
    else:
        assert "encoder.base_model.layer1.0.downsample.1.weight" not in frozen
        assert "encoder.base_model.layer1.0.bn2.weight" in frozen
