"""``scripts/export_orbax_to_pth.py``: a bts_tpu orbax checkpoint, saved under
tmp_path, exported to a .pth that the port serves and resumes from. The
port's outputs on the export against bts_tpu's on the checkpoint (CPU, f32,
test_torch_model.py's tolerance), global_step and the best tracker carried,
and a TF-graph run sniffed as 'tf'. A narrow DenseNet at 64x96."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.training import checkpoint as jcheckpoint
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.apps.predict import load_model
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.training import checkpoint, optim, state

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from test_torch_tf_flavor import randomize
from test_torch_tf_train import TINY_TF, _register
from torch_train_helpers import H, W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "export_orbax_to_pth", os.path.join(ROOT, "scripts", "export_orbax_to_pth.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _variables(jcfg, seed):
    jmodel = jbts.create_model(jcfg)
    params, stats = jbts.init_model(jmodel, jax.random.key(seed), (1, H, W, 3))
    return jmodel, *randomize(params, stats, np.random.default_rng(seed))


def _outputs_match(cfg, jmodel, params, stats):
    """The port's load_model(cfg) against bts_tpu's model on (params, stats)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    focal = np.full((2,), 518.8579, np.float32)
    want = jax.jit(jmodel.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 jnp.asarray(focal))
    model = load_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(focal))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **MODEL_TOL)


def test_full_checkpoint_exports_and_resumes(script, tiny_encoder, tmp_path, capsys):
    """A full training checkpoint (step 5, a best tracker): the export serves
    with bts_tpu's outputs and resumes at step 5 with the best tracker; the
    PT graph is sniffed as 'pt'."""
    kw = dict(encoder=tiny_encoder, bts_size=128, fast_tail=False, lpg_impl="xla")
    jmodel, params, stats = _variables(JConfig(**kw), 1)
    tx, _ = joptim.create_optimizer(JConfig(**kw), params, 50)
    jst = jstate.create_train_state(params, stats, tx).replace(step=jnp.asarray(5))
    best = jcheckpoint.BestTracker()
    best.update(np.linspace(0.1, 0.9, 9), 5)
    src = str(tmp_path / "run" / "model-5")
    jcheckpoint.save_checkpoint(src, jst, best)

    out = str(tmp_path / "model-5.pth")
    assert script.main([src, out]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    cfg = Config(**kw, checkpoint_path=out)
    assert cfg.resolved_flavor == "pt"
    _outputs_match(cfg, jmodel, params, stats)

    model = bts.create_model(cfg)
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st, tracker = checkpoint.restore_training_start(cfg, state.TrainState(model, opt),
                                                    checkpoint.BestTracker())
    assert st.step == 5
    np.testing.assert_array_equal(tracker.lower, best.lower)
    np.testing.assert_array_equal(tracker.higher, best.higher)
    np.testing.assert_array_equal(tracker.steps, best.steps)


def test_tf_graph_run_exports_as_tf(script, monkeypatch, tmp_path):
    """A params-only checkpoint of bts_tpu's TF graph: its export carries the
    decoder's biases, so 'auto' resolves the TF graph, and the port's
    outputs match bts_tpu's; no global_step stored reads as step 0."""
    _register(monkeypatch)
    kw = dict(encoder=TINY_TF, bts_size=128, fast_tail=False, lpg_impl="xla")
    jmodel, params, stats = _variables(JConfig(**kw, model_flavor="tf"), 2)
    src = str(tmp_path / "params")
    jcheckpoint.save_params_only(src, params, stats)
    out = str(tmp_path / "tf.pth")
    payload = script.export(src, out)
    assert payload["global_step"] == 0 and "decoder.get_depth.0.bias" in payload["model"]
    cfg = Config(**kw, checkpoint_path=out)
    assert cfg.resolved_flavor == "tf"
    _outputs_match(cfg, jmodel, params, stats)


def test_port_refuses_the_directory_and_names_the_script(script, tmp_path):
    from bts_tpu_torch.config import parse_args

    with pytest.raises(NotImplementedError, match="export_orbax_to_pth"):
        parse_args(["--checkpoint_path", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        script.export(str(tmp_path / "missing"), str(tmp_path / "x.pth"))
