"""The port's training pieces against bts_tpu's on the CPU: the silog loss,
the LR schedules, set_misc freezing, the optimizer against optax, the
schedule count after a restore, and the plain LPG backward composition that
the backward kernel fuses."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import flax_path_to_torch_key
from bts_tpu.ops import lpg as jlpg
from bts_tpu.training import loss as jloss
from bts_tpu.training import lr as jlr
from bts_tpu.training import optim as joptim
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.ops import lpg as tlpg
from bts_tpu_torch.training import loss, lr, optim

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, cfgs, named_leaves, tiny_variables, to_flax


# ---------------------------------------------------------------- loss, LR


@pytest.mark.parametrize("valid_share", [0.7, 0.001, 0.0])
def test_silog_loss_matches(valid_share):
    rng = np.random.default_rng(1)
    est = rng.uniform(0.05, 10.0, (2, H, W)).astype(np.float32)
    gt = rng.uniform(0.0, 10.0, (2, H, W)).astype(np.float32)
    mask = rng.random((2, H, W)) < valid_share
    if valid_share == 0.001:
        mask[:] = False
        mask[1, 3, 5] = mask[0, 60, 90] = True  # an almost empty mask
    gt[~mask] = 0.0  # masked-out entries may be 0: their log is guarded
    want = np.asarray(jloss.silog_loss(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask), 0.85))
    got = loss.silog_loss(torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(mask), 0.85)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # bf16 estimates: the loss is still taken in f32.
    got16 = loss.silog_loss(torch.from_numpy(est).bfloat16(), torch.from_numpy(gt),
                            torch.from_numpy(mask))
    assert got16.dtype == torch.float32 and torch.isfinite(got16)


def test_lr_schedules_match_over_the_whole_range():
    total = 997
    got, want = lr.polynomial_decay(1e-4, 1e-5, total), jlr.polynomial_decay(1e-4, 1e-5, total)
    got_h, want_h = (lr.polynomial_decay_host(1e-4, 1e-5, total),
                     jlr.polynomial_decay_host(1e-4, 1e-5, total))
    for step in range(total + 5):
        g = got(step)
        assert g.dtype == torch.float32
        # f32 pow in XLA and in PyTorch may differ by one ulp.
        np.testing.assert_allclose(g.item(), float(want(jnp.int32(step))), rtol=1e-6)
        assert got_h(step) == want_h(step)
    cfg, jcfg = cfgs(learning_rate=3e-4)
    assert cfg.resolved_end_learning_rate == jcfg.resolved_end_learning_rate == 3e-4 * 0.1
    cfg, jcfg = cfgs(learning_rate=3e-4, end_learning_rate=1e-6)
    assert cfg.resolved_end_learning_rate == jcfg.resolved_end_learning_rate == 1e-6


# ------------------------------------------------------------ freezing


@pytest.mark.parametrize("fix", [{}, {"fix_first_conv_block": True},
                                 {"fix_first_conv_blocks": True}], ids=["none", "block", "blocks"])
@pytest.mark.parametrize("encoder", ["densenet121_bts", "densenet161_bts"])
def test_frozen_encoder_decoder_sets_match(encoder, fix):
    cfg, jcfg = cfgs(encoder=encoder, bts_size=512, fast_tail=False, **fix)
    jmodel = jbts.create_model(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), jnp.ones((1,)))
    )["params"]
    want = {}
    for path, label in jax.tree_util.tree_leaves_with_path(joptim.param_labels(shapes, jcfg)):
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        leaf = shapes
        for k in keys:
            leaf = leaf[k]
        want[flax_path_to_torch_key(keys, leaf.shape)] = label
    model = bts.BTSModel(encoder)
    assert optim.param_labels(model, cfg) == want
    frozen = {n for n, v in want.items() if v == "frozen"}
    assert "encoder.base_model.conv0.weight" in frozen
    assert ("encoder.base_model.denseblock1.denselayer2.conv1.weight" in frozen) == bool(
        fix.get("fix_first_conv_blocks"))
    optim.create_optimizer(cfg, model, 10)
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == frozen


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("bf16_moments", [False, True], ids=["f32_mu", "bf16_mu"])
def test_optimizer_matches_optax(tiny_encoder, bf16_moments):
    kw = dict(encoder=tiny_encoder, bts_size=128, fast_tail=False, learning_rate=1e-3,
              weight_decay=1e-2, adam_eps=1e-3, adam_bf16_moments=bf16_moments,
              fix_first_conv_block=True)
    cfg, jcfg = cfgs(**kw)
    _, params, stats = tiny_variables(tiny_encoder, jcfg)
    tx, _ = joptim.create_optimizer(jcfg, params, 40)
    opt_state = tx.init(params)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    opt, _ = optim.create_optimizer(cfg, model, 40)
    labels = optim.param_labels(model, cfg)
    assert {"frozen", "encoder", "decoder"} == set(labels.values())
    rng = np.random.default_rng(5)
    named = dict(model.named_parameters())
    for _ in range(5):
        grads = {n: (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-5, 0)).astype(np.float32)
                 for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n]) if p.requires_grad else None
        opt.step()
        updates, opt_state = tx.update(to_flax(grads, params), opt_state, params)
        params = optax.apply_updates(params, updates)
        want = state_dict_from_flax(params, stats)
        for n, p in named.items():
            # rtol 1e-6: optax's LR and bias corrections come from XLA's f32
            # pow, PyTorch's from its own, which may differ by one ulp, and
            # XLA contracts some of optax's f32 arithmetic into FMAs. atol
            # 1e-8 (1e-5 of the LR, so of an update) for parameters near 0.
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-8,
                                       err_msg=n)
            if labels[n] == "frozen":
                assert n not in opt.state
        for group in ("encoder", "decoder"):
            mu = named_leaves(opt_state.inner_states[group].inner_state[0].mu)
            assert mu and {n for n in mu} == {n for n, v in labels.items() if v == group}
            for n, want_mu in mu.items():
                got_mu = opt.state[n]["mu"]
                assert got_mu.dtype == (torch.bfloat16 if bf16_moments else torch.float32)
                assert want_mu.dtype == (jnp.bfloat16 if bf16_moments else jnp.float32)
                if bf16_moments:  # the stored first moment, bit for bit
                    np.testing.assert_array_equal(got_mu.float().numpy(),
                                                  want_mu.astype(np.float32), err_msg=n)


def test_advance_schedule_count_applies_the_restored_lr(tiny_encoder):
    kw = dict(encoder=tiny_encoder, bts_size=128, fast_tail=False, learning_rate=1e-3,
              adam_eps=1e-3)
    cfg, jcfg = cfgs(**kw)
    _, params, stats = tiny_variables(tiny_encoder, jcfg)
    tx, schedule = joptim.create_optimizer(jcfg, params, 100)
    opt_state = joptim.advance_schedule_count(tx.init(params), 37)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    opt, tschedule = optim.create_optimizer(cfg, model, 100)
    optim.advance_schedule_count(opt, 37)
    assert opt.applied_lr() == tschedule(37).item()
    np.testing.assert_allclose(opt.applied_lr(), float(schedule(37)), rtol=1e-6)
    assert all(g["count"] == 0 for g in opt.groups.values())
    rng = np.random.default_rng(2)
    grads = {n: rng.normal(size=p.shape).astype(np.float32) for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n]) if p.requires_grad else None
    opt.step()
    updates, _ = tx.update(to_flax(grads, params), opt_state, params)
    want = state_dict_from_flax(optax.apply_updates(params, updates), stats)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------- LPG backward


@pytest.mark.parametrize("r", [2, 4, 8])
def test_lpg_backward_scaled_matches_jax_vjp_with_bf16_grad(r):
    """The plain composition the backward kernel fuses (bf16 gradient cast
    to f32, divided by max_depth, then the analytic VJP) against jax.vjp of
    bts_tpu's decoder site (LPG, / max_depth, cast to bf16)."""
    rng = np.random.default_rng(10 + r)
    theta = rng.uniform(0.05, np.pi / 3, (2, 3, 5))
    phi = rng.uniform(0, 2 * np.pi, (2, 3, 5))
    pe = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta),
                   rng.uniform(0.5, 10.0, (2, 3, 5))], -1).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(2, 3 * r, 5 * r)).astype(np.float32)).bfloat16()
    got = tlpg.lpg_backward_scaled(torch.from_numpy(pe), g, r, 10.0)

    def site(p):
        return (jlpg.local_planar_guidance(p, r, impl="pallas") / 10.0).astype(jnp.bfloat16)

    _, vjp = jax.vjp(site, jnp.asarray(pe))
    want = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))[0]
    # As tests/test_torch_lpg.py's VJP test: the sums run in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # The autograd path on a CPU tensor is this composition, bit for bit.
    p = torch.from_numpy(pe).requires_grad_(True)
    tlpg.local_planar_guidance(p, r, max_depth=10.0, out_dtype=torch.bfloat16).backward(g)
    assert torch.equal(p.grad, got)
