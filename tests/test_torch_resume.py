"""A bts_tpu run resumed in the port, and the port's background checkpoint
writer (``--async_checkpoint``), on the CPU with the tiny DenseNet at 64x96.

* optax's ``multi_transform`` state, saved by bts_tpu and exported by
  ``scripts/export_orbax_to_pth.py``, loads into the port's ``AdamW`` with
  every ``mu``/``nu`` leaf equal to bts_tpu's after the key map and both
  counts of each group equal (f32 and bf16 ``mu``, and the TF graph);
* a bts_tpu run saved after 2 steps and continued for 2 more: the port,
  resumed from the export, takes the same 2 steps to bts_tpu's parameters
  at test_torch_train_step.py's tolerance, and without the moments lands
  farther than it;
* ``save_checkpoint(async_save=True)``: the file holds the state at the
  save, a writer's error is raised at the wait, ``prune_step_checkpoints``
  waits for the save in flight, and ``train`` leaves the same files with
  and without ``--async_checkpoint``."""

import importlib.util
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.training import checkpoint as jcheckpoint
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.training import checkpoint, optim, state
from bts_tpu_torch.training.loop import train

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from test_torch_tf_train import TINY_TF, _register
from test_torch_train_loop import _fake_steps, _loop_cfg, _small_state
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, cfgs, named_leaves, tiny_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_ATOL = 1e-5  # test_torch_train_step.py's, parameters and BN statistics


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "export_orbax_to_pth", os.path.join(ROOT, "scripts", "export_orbax_to_pth.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _resume(cfg, path):
    """A fresh port model and optimizer through restore_training_start."""
    cfg = cfg.replace(checkpoint_path=path)
    model = bts.create_model(cfg)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st, _ = checkpoint.restore_training_start(cfg, state.TrainState(model, opt),
                                              checkpoint.BestTracker())
    return st


@pytest.mark.parametrize("case", ["f32_mu", "bf16_mu", "tf_graph"])
def test_optax_state_maps_onto_adamw(script, tiny_encoder, monkeypatch, tmp_path, case):
    """Two ``tx.update`` calls of bts_tpu's create_optimizer on seeded
    parameters of the model's shapes (no model forward; the update jitted,
    one compile in place of an eager one per leaf shape) with seeded
    gradients, saved by bts_tpu and exported: every moment equal to its flax
    leaf after the key map (bit for bit, in its dtype), both counts of each
    group equal, no state for the frozen parameters."""
    encoder, flavor = tiny_encoder, "pt"
    if case == "tf_graph":
        _register(monkeypatch)
        encoder, flavor = TINY_TF, "tf"
    bf16 = case == "bf16_mu"
    kw = dict(encoder=encoder, bts_size=128, fast_tail=False, lpg_impl="xla",
              model_flavor=flavor, adam_bf16_moments=bf16, weight_decay=1e-2, adam_eps=1e-3)
    jcfg = JConfig(**kw)
    model = jbts.create_model(jcfg)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, H, W, 3)), jnp.ones((1,))),
                            jax.random.key(0))
    rng = np.random.default_rng(1)
    params, stats = (jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                                  shapes[k]) for k in ("params", "batch_stats"))
    tx, _ = joptim.create_optimizer(jcfg, params, 50)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    src = str(tmp_path / "run" / "model-2")
    jcheckpoint.save_checkpoint(src, jstate.create_train_state(params, stats, tx).replace(
        opt_state=opt_state, step=jnp.asarray(2)))
    out = str(tmp_path / "model-2.pth")
    script.export(src, out)

    st = _resume(Config(**kw), out)
    assert st.step == 2
    trained = set()
    for gname in ("encoder", "decoder"):
        adam, _, schedule = opt_state.inner_states[gname].inner_state
        group = st.optimizer.groups[gname]
        assert group["count"] == int(adam.count) == 2
        assert group["schedule_count"] == int(schedule.count) == 2
        for k, dtype in (("mu", torch.bfloat16 if bf16 else torch.float32),
                         ("nu", torch.float32)):
            want = named_leaves(getattr(adam, k))
            assert {n for n, _ in group["params"]} == set(want)
            for n, w in want.items():
                got = st.optimizer.state[n][k]
                assert got.dtype == dtype, n
                np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32),
                                              err_msg=f"{n} {k}")
        trained |= {n for n, _ in group["params"]}
    assert set(st.optimizer.state) == trained
    frozen = {n for n, p in st.model.named_parameters() if not p.requires_grad}
    assert frozen and not frozen & trained

    # A run that keeps mu in the other dtype refuses the state.
    with pytest.raises(ValueError, match="saved mu is"):
        _resume(Config(**{**kw, "adam_bf16_moments": not bf16}), out)


def test_resumed_run_follows_bts_tpu(script, tiny_encoder, tmp_path):
    """bts_tpu takes 2 steps, saves, takes 2 more; the port resumed from the
    export takes the same 2 batches to bts_tpu's state within STATE_ATOL
    (1.3e-6 here). With the moments dropped (a fresh optimizer at the step)
    it lands 2.3e-4 away.

    The BN statistics are frozen (``bn_no_track_stats``): with BN in train
    mode bts_tpu's own f32 gradient is off by up to 4e-2 of a leaf's scale
    in the Dense-ASPP layers (test_torch_train_step.py), which by Adam's
    third and fourth steps puts an uninterrupted port run 2.2e-5 from
    bts_tpu's too, resumed or not."""
    kw = dict(encoder=tiny_encoder, dataset="nyu", max_depth=10.0, bts_size=128,
              fast_tail=False, lpg_impl="xla", learning_rate=1e-4, weight_decay=1e-2,
              adam_eps=1e-3, batch_size=2, input_height=H, input_width=W,
              bn_no_track_stats=True)
    cfg, jcfg = cfgs(**kw)
    jmodel, params, stats = tiny_variables(tiny_encoder, jcfg, seed=3)
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(2, H, W, 3)).astype(np.float32),
                "depth": rng.uniform(0.0, 10.0, (2, H, W, 1)).astype(np.float32),
                "focal": np.array([518.8579, 518.8579], np.float32)} for _ in range(4)]
    tx, _ = joptim.create_optimizer(jcfg, params, 50)
    jstep = jax.jit(jstate.make_train_step(jmodel, tx, jcfg))
    jst = jstate.create_train_state(params, stats, tx)
    src = str(tmp_path / "run" / "model-2")
    for i, b in enumerate(batches):
        if i == 2:
            jcheckpoint.save_checkpoint(src, jst)
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
    want = state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                jax.tree.map(np.asarray, jst.batch_stats))
    out = str(tmp_path / "model-2.pth")
    payload = script.export(src, out)
    dropped = str(tmp_path / "weights-only.pth")
    torch.save({k: v for k, v in payload.items() if k != "optimizer"}, dropped)

    def continued(path):
        st = _resume(cfg, path)
        assert st.step == 2
        step = state.make_train_step(cfg)
        for b in batches[2:]:
            step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        got = st.model.state_dict()
        return max(float((got[n] - w).abs().max()) for n, w in want.items()
                   if w.is_floating_point())

    assert continued(out) <= STATE_ATOL
    assert continued(dropped) > STATE_ATOL


# ------------------------------------------------------------ async saves


def test_async_save_holds_the_state_at_the_save(tiny_encoder, tmp_path):
    """The parameters and moments changed in place right after an async save:
    the file holds the values from before, tensor for tensor as a sync save
    of that state; ``mu`` keeps its bf16."""
    _, st, _ = _small_state(tiny_encoder, adam_bf16_moments=True)
    _fake_steps(st, 2)
    sync, asyn = str(tmp_path / "sync"), str(tmp_path / "async")
    checkpoint.save_checkpoint(sync, st)
    checkpoint.save_checkpoint(asyn, st, async_save=True)
    with torch.no_grad():
        for _, p in st.optimizer.named_params():
            p.add_(1.0)
        for s in st.optimizer.state.values():
            s["nu"].mul_(2.0)
    _fake_steps(st, 1, seed=1)
    checkpoint.wait_for_async_saves()
    a, b = checkpoint.load_checkpoint_dict(sync), checkpoint.load_checkpoint_dict(asyn)
    for key in ("model", "optimizer"):
        flat_a, flat_b = _flat(a[key]), _flat(b[key])
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == flat_b[k].dtype and torch.equal(v, flat_b[k]), k
            else:
                assert v == flat_b[k], k
    assert any(v.dtype == torch.bfloat16 for v in _flat(b["optimizer"]).values()
               if isinstance(v, torch.Tensor))
    assert b["global_step"] == 2
    assert not torch.equal(b["model"]["decoder.get_depth.0.weight"],
                           st.model.state_dict()["decoder.get_depth.0.weight"])


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_async_writer_error_raises_at_the_wait(tiny_encoder, tmp_path):
    _, st, _ = _small_state(tiny_encoder)
    checkpoint.save_checkpoint(str(tmp_path / "missing" / "model-1"), st, async_save=True)
    with pytest.raises(RuntimeError, match="missing"):
        checkpoint.wait_for_async_saves()
    checkpoint.wait_for_async_saves()  # raised once, then cleared


def test_prune_waits_for_the_save_in_flight(tiny_encoder, tmp_path, monkeypatch):
    """model-1 and model-2 on disk, model-3 in flight on a slow writer:
    pruning to 2 counts model-3 and leaves model-2 and model-3."""
    real = checkpoint._write

    def slow(*args):
        time.sleep(0.5)
        real(*args)

    monkeypatch.setattr(checkpoint, "_write", slow)
    _, st, _ = _small_state(tiny_encoder)
    for s in (1, 2):
        (tmp_path / f"model-{s}").write_bytes(b"x")
    checkpoint.save_checkpoint(str(tmp_path / "model-3"), st, async_save=True)
    checkpoint.prune_step_checkpoints(str(tmp_path), 2)
    assert sorted(checkpoint.list_step_checkpoints(str(tmp_path))) == [2, 3]


def test_train_with_async_checkpoint_leaves_the_same_files(tiny_encoder, tmp_path):
    """4 steps, a save every step, 2 kept: model-3 and model-4, with and
    without --async_checkpoint, and model-4 the same tensors in both."""
    runs = {}
    for mode in (False, True):
        cfg = _loop_cfg(tiny_encoder, tmp_path / str(mode), save_freq=1, max_to_keep=2,
                        async_checkpoint=mode)
        assert train(cfg, device=torch.device("cpu")) == 4
        run_dir = str(tmp_path / str(mode) / "logs" / "tiny_run")
        assert sorted(checkpoint.list_step_checkpoints(run_dir)) == [3, 4]
        runs[mode] = (sorted(os.listdir(run_dir)),
                      checkpoint.load_checkpoint_dict(os.path.join(run_dir, "model-4")))
    assert runs[False][0] == runs[True][0]
    for k, v in runs[False][1]["model"].items():
        assert torch.equal(v, runs[True][1]["model"][k]), k
