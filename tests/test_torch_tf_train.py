"""Two train steps of the TF graph (every BN frozen) against bts_tpu's on the
CPU in f32, and the training loop on the TF graph leaving every BN statistic
as it was. A narrow DenseNet (tests/test_torch_model.py's) at 64x96; bts_tpu's
LPG is its plain XLA version with its custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.models.encoders import densenet
from bts_tpu_torch.training import optim, state
from bts_tpu_torch.training.loop import train

from test_torch_model import tiny_jax
from test_torch_tf_flavor import randomize
from test_torch_train_loop import _loop_cfg
from test_torch_train_step import _bts_tpu_grads_float64
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W

# -------------------------------------------------------------- train steps

TINY_TF = "tiny_tf_densenet_bts"
TINY_CHANNELS = [16, 16, 16, 16, 32]


def tiny_torch_tf(bn_eps=1e-5, tf_stem=False):
    return densenet.DenseNetEncoder((2, 2, 2, 2), 8, 16, bn_eps=bn_eps, tf_stem=tf_stem)


def _register(monkeypatch):
    monkeypatch.setitem(jbts.ENCODERS, TINY_TF, (tiny_jax, TINY_CHANNELS))
    monkeypatch.setitem(bts.ENCODERS, TINY_TF, (tiny_torch_tf, TINY_CHANNELS))


def test_tf_train_steps_match_bts_tpu(monkeypatch):
    """Two TF-graph train steps (every BN frozen, as bts_tpu's make_train_step
    runs the TF graph) against bts_tpu's make_train_step and create_optimizer
    on a narrow DenseNet, f32, at test_torch_train_step.py's tolerances: the
    loss at rtol 1e-5; step 1's gradient of every leaf within 1e-4 of that
    leaf's largest magnitude of bts_tpu's gradient in float64; parameters
    after the two steps at atol 1e-5; no BN statistic moved."""
    _register(monkeypatch)
    kw = dict(encoder=TINY_TF, dataset="nyu", max_depth=10.0, bts_size=128, fast_tail=False,
              lpg_impl="xla", learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3,
              batch_size=2, input_height=H, input_width=W, model_flavor="tf")
    cfg, jcfg = Config(**kw), JConfig(**kw)
    jmodel = jbts.create_model(jcfg)
    params, stats = jbts.init_model(jmodel, jax.random.key(3), (1, H, W, 3))
    params, stats = randomize(params, stats, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    batches = [{"image": rng.normal(size=(2, H, W, 3)).astype(np.float32),
                "depth": rng.uniform(0.0, 10.0, (2, H, W, 1)).astype(np.float32),
                "focal": np.array([518.8579, 518.8579], np.float32)} for _ in range(2)]
    grads64 = _bts_tpu_grads_float64(jcfg, params, stats, batches[0], False)

    tx, _ = joptim.create_optimizer(jcfg, params, 50)
    jstep = jax.jit(jstate.make_train_step(jmodel, tx, jcfg))
    jst = jstate.create_train_state(params, stats, tx)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg)

    for i, b in enumerate(batches):
        jst, metrics = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        got = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(metrics["loss"]), rtol=1e-5)
        if i == 0:
            assert any(n.endswith(".bias") and n.startswith("decoder.") and p.grad is not None
                       for n, p in model.named_parameters())
            for n, p in model.named_parameters():
                if not p.requires_grad:
                    continue
                scale = float(grads64[n].abs().max())
                np.testing.assert_allclose(p.grad.double().numpy(), grads64[n].numpy(), rtol=0,
                                           atol=1e-4 * scale, err_msg=n)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                jax.tree.map(np.asarray, jst.batch_stats))
    got = model.state_dict()
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=n)
    frozen = [n for n in got if "running_" in n or n.endswith("num_batches_tracked")]
    assert frozen and all(torch.equal(got[n], before[n]) for n in frozen)


def test_train_loop_on_the_tf_graph_keeps_bn_statistics(monkeypatch, tmp_path):
    """``train`` with --model_flavor tf for two steps on the CPU: finite
    steps, and the saved model-2 holds every BN statistic as seeded (running
    mean 0, variance 1, no batch counted); the PT graph's loop moves them."""
    _register(monkeypatch)
    saved = {}
    for flavor in ("tf", "pt"):
        cfg = _loop_cfg(TINY_TF, tmp_path / flavor, save_freq=2, model_flavor=flavor)
        assert train(cfg, max_steps=2, device=torch.device("cpu")) == 2
        saved[flavor] = torch.load(tmp_path / flavor / "logs" / "tiny_run" / "model-2",
                                   weights_only=True)["model"]
    assert "decoder.get_depth.0.bias" in saved["tf"]
    stats = [k for k in saved["tf"] if "running_" in k or k.endswith("num_batches_tracked")]
    assert stats
    for k in stats:
        v = saved["tf"][k]
        want = 1.0 if k.endswith("running_var") else 0.0
        assert torch.equal(v, torch.full_like(v, want)), k
    assert any(not torch.equal(saved["pt"][k], saved["tf"][k]) for k in stats)
