"""The port's train step against bts_tpu's make_train_step and
create_optimizer on the CPU, in f32, over two steps, with BN in train mode
and under bn_no_track_stats; bts_tpu's gradient in float64 as the reference
for the port's gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models import bts as jbts
from bts_tpu.training import loss as jloss
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.training import optim, state

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, cfgs, tiny_variables


def _loss_and_grads(jmodel, params, stats, batch, jcfg, bn_train):
    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        if bn_train:
            outs, _ = jmodel.apply(variables, batch["image"], batch["focal"], train=True,
                                   mutable=["batch_stats"])
        else:
            outs = jmodel.apply(variables, batch["image"], batch["focal"], train=False)
        gt = batch["depth"][..., 0]
        return jloss.silog_loss(outs[4][..., 0], gt, gt > jcfg.depth_mask_min, jcfg.variance_focus)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


class _Float64Numpy:
    """jax.numpy with float32 read as float64: bts_tpu's BN takes its batch
    statistics in f32 by construction (models/layers.py:309-313), also in an
    f64 model."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _bts_tpu_grads_float64(jcfg, params, stats, batch, bn_train):
    """bts_tpu's gradient of the step's loss, evaluated in float64."""
    from bts_tpu.models import layers as jlayers

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jlayers, "jnp", _Float64Numpy())
            jcfg64 = dataclasses.replace(jcfg, compute_dtype="float64")
            f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
            _, grads = _loss_and_grads(jbts.create_model(jcfg64), f64(params), f64(stats),
                                       f64(batch), jcfg64, bn_train)
        return state_dict_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float64), grads), {})
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("bn_no_track_stats", [False, True], ids=["bn_train", "bn_no_track"])
def test_train_step_matches_bts_tpu(tiny_encoder, bn_no_track_stats):
    """Two steps against bts_tpu's make_train_step + create_optimizer, f32:
    the loss at rtol 1e-5, parameters and BN statistics after the two steps
    at atol 1e-5. Step 1's gradient of every leaf within 1e-4 of that leaf's
    largest magnitude of bts_tpu's gradient in float64: with BN in train
    mode bts_tpu's own f32 gradients are off by up to 4e-2 of that in the
    Dense-ASPP layers (its batch variance is a mean of squares in f32), while
    the port's f32 gradient stays within 3e-5 of the f64 one."""
    kw = dict(encoder=tiny_encoder, dataset="nyu", max_depth=10.0, bts_size=128, fast_tail=False,
              lpg_impl="pallas", learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3,
              batch_size=2, input_height=H, input_width=W, bn_no_track_stats=bn_no_track_stats)
    cfg, jcfg = cfgs(**kw)
    jmodel, params, stats = tiny_variables(tiny_encoder, jcfg, seed=3)
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(2, H, W, 3)).astype(np.float32),
                "depth": rng.uniform(0.0, 10.0, (2, H, W, 1)).astype(np.float32),
                "focal": np.array([518.8579, 518.8579], np.float32)} for _ in range(2)]
    grads64 = _bts_tpu_grads_float64(jcfg, params, stats, batches[0], not bn_no_track_stats)

    tx, _ = joptim.create_optimizer(jcfg, params, 50)
    jstep = jax.jit(jstate.make_train_step(jmodel, tx, jcfg))
    jst = jstate.create_train_state(params, stats, tx)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg)

    for i, b in enumerate(batches):
        jst, metrics = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        got = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(metrics["loss"]), rtol=1e-5)
        if i == 0:
            for n, p in model.named_parameters():
                if not p.requires_grad:
                    continue
                scale = float(grads64[n].abs().max())
                np.testing.assert_allclose(p.grad.double().numpy(), grads64[n].numpy(), rtol=0,
                                           atol=1e-4 * scale, err_msg=n)
    assert st.step == 2
    want = state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                jax.tree.map(np.asarray, jst.batch_stats))
    got = model.state_dict()
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=n)
    moved = [n for n in want if n.endswith("running_mean")
             and not torch.equal(got[n], state_dict_from_flax(params, stats)[n])]
    assert bool(moved) == (not bn_no_track_stats)
