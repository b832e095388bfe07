"""The port's online eval, offline eval, eval schedule, eval CLIs and the
train loop's ``--do_online_eval`` on the CPU, against bts_tpu's where it
has a counterpart (as tests/test_hetero_eval.py, test_eval_apps.py,
test_multiprocess_sim.py and test_logging_schedule.py hold bts_tpu's)."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from bts_tpu.config import Config as JConfig
from bts_tpu.evaluation import online as jonline
from bts_tpu.evaluation import png_eval as jpng
from bts_tpu_torch.cli import eval as cli_eval
from bts_tpu_torch.cli import eval_schedule as cli_eval_schedule
from bts_tpu_torch.cli import eval_with_pngs as cli_eval_with_pngs
from bts_tpu_torch.config import Config
from bts_tpu_torch.data.loader import EvalLoader
from bts_tpu_torch.evaluation import offline, schedule
from bts_tpu_torch.evaluation.metrics import EVAL_METRICS
from bts_tpu_torch.evaluation.online import allgather_vector, make_eval_forward, run_online_eval
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from bts_tpu_torch.training import checkpoint, state
from bts_tpu_torch.training.loop import train

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, tiny_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _write_nyu(root, sizes, seed=5):
    """NYU-style rgb/depth pairs of the given (h, w) sizes and a manifest."""
    scene = root / "kitchen_0001"
    scene.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            scene / f"rgb_{i:05d}.jpg")
        Image.fromarray(rng.integers(500, 9000, (h, w), dtype=np.uint16)).save(
            scene / f"sync_depth_{i:05d}.png")
        lines.append(f"kitchen_0001/rgb_{i:05d}.jpg kitchen_0001/sync_depth_{i:05d}.png 518.8579")
    manifest = root / "files.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


def _eval_kw(root, manifest, **kw):
    """The same eval fields for both packages' Configs."""
    return dict(dataset="nyu", max_depth=10.0, data_path_eval=str(root), gt_path_eval=str(root),
                filenames_file_eval=str(manifest), data_path=str(root), gt_path=str(root),
                filenames_file=str(manifest), min_depth_eval=1e-3, max_depth_eval=10.0,
                eval_batch_size=2, input_height=H, input_width=W, **kw)


@pytest.fixture
def nyu_eval(tmp_path):
    root = tmp_path / "data"
    return root, _write_nyu(root, [(H, W)] * 5)


def _tiny_pair(tiny_encoder, **kw):
    """bts_tpu's tiny model with seeded variables and the port's with the same
    weights, and both Configs."""
    jcfg = JConfig(encoder=tiny_encoder, bts_size=128, fast_tail=False, **kw)
    jmodel, params, stats = tiny_variables(tiny_encoder, jcfg)
    cfg = Config(encoder=tiny_encoder, bts_size=128, **kw)
    model = bts.create_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return cfg, model, jcfg, jmodel, {"params": params, "batch_stats": stats}


# ------------------------------------------------------------ online eval


def test_online_eval_matches_bts_tpu(tiny_encoder, nyu_eval):
    """run_online_eval with the same weights (state_dict_from_flax) over 5
    frames at batch 2 (a padded last batch), device metrics on and off, with
    and without the eigen crop (whose fixed region lies past 64x96: no pixel
    valid, zero measures). Against bts_tpu at rtol 1e-5: the two f32
    forwards and the metric sums round in another order (about 2e-7 of a
    measure here); device against host in the port as test_eval_apps.py
    holds bts_tpu's, rtol 1e-4, atol 1e-5."""
    root, manifest = nyu_eval
    cfg, model, jcfg, jmodel, variables = _tiny_pair(tiny_encoder, **_eval_kw(root, manifest))
    jforward = jonline.make_eval_forward(jmodel)
    for crop in ({}, {"eigen_crop": True}):
        res = {}
        for device_eval in (True, False):
            got = run_online_eval(model, cfg.replace(device_eval=device_eval, **crop),
                                  verbose=False)
            want = jonline.run_online_eval(
                jmodel, variables, jcfg.replace(device_eval=device_eval, **crop),
                forward=jforward, verbose=False)
            assert got.shape == (9,) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
            res[device_eval] = got
        np.testing.assert_allclose(res[True], res[False], rtol=1e-4, atol=1e-5)
    assert 0 <= res[True][EVAL_METRICS.index("d1")] <= 1


def _fake_forward(image, focal):
    return np.full(image.shape[:3], 3.0, np.float32)


def _jfake_forward(variables, image, focal):
    return _fake_forward(image, focal)


MIXED = [(32, 64), (64, 32), (32, 64), (32, 64), (64, 32)]


@pytest.mark.parametrize("device_eval", [True, False])
def test_online_eval_exact_count_mixed_sizes(tmp_path, device_eval, capsys):
    """Mixed resolutions (test_hetero_eval.py): every sample scored once, the
    same table as bts_tpu's on the same predictions (rtol 1e-5: f32 sums in
    another order on the device path; the host path is the same numpy)."""
    root = tmp_path / "data"
    kw = _eval_kw(root, _write_nyu(root, MIXED), device_eval=device_eval)
    got = run_online_eval(None, Config(**kw), forward=_fake_forward)
    out = capsys.readouterr().out
    assert "Computing errors for 5 eval samples" in out
    want = jonline.run_online_eval(None, None, JConfig(**kw), forward=_jfake_forward,
                                   verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0.0 <= got[6] <= 1.0 and got[3] > 0


@pytest.mark.parametrize("device_eval", [True, False])
def test_online_eval_gt_size_mismatch_warns_not_crashes(tmp_path, device_eval):
    """A gt png whose size differs from its image is excluded with a warning;
    the other samples count, alike on both metric paths."""
    root = tmp_path / "data"
    manifest = _write_nyu(root, [(32, 64)] * 4)
    Image.fromarray(np.random.default_rng(1).integers(2000, 9000, (16, 32), dtype=np.uint16)).save(
        root / "kitchen_0001" / "sync_depth_00002.png")
    kw = _eval_kw(root, manifest)
    with pytest.warns(UserWarning):
        got = run_online_eval(None, Config(**kw, device_eval=device_eval), forward=_fake_forward,
                              verbose=False)
    with pytest.warns(UserWarning):
        other = run_online_eval(None, Config(**kw, device_eval=not device_eval),
                                forward=_fake_forward, verbose=False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, other, rtol=1e-5)


def test_online_eval_all_missing_gt_batch_skips_the_device(tmp_path, monkeypatch):
    root = tmp_path / "data"
    manifest = _write_nyu(root, [(32, 64)] * 4)
    for i in (0, 1):
        (root / "kitchen_0001" / f"sync_depth_{i:05d}.png").unlink()
    from bts_tpu_torch.evaluation import device_eval

    real, calls = device_eval.make_batch_metrics, []

    def counting(cfg):
        fn = real(cfg)
        return lambda *a: calls.append(1) or fn(*a)

    monkeypatch.setattr(device_eval, "make_batch_metrics", counting)
    got = run_online_eval(None, Config(**_eval_kw(root, manifest)), forward=_fake_forward,
                          verbose=False)
    assert np.isfinite(got).all() and len(calls) == 1


def test_online_eval_simulated_3process_equals_single(tiny_encoder, nyu_eval, tmp_path):
    """test_multiprocess_sim.py: three ranks on [r::3] shards, their metric
    vectors gathered by an injected allgather, give the one-process measures
    (rtol 1e-6: the shards batch other images together than one process
    does, and the CPU's convolutions round batches of 1 and 2 apart, by
    about 5e-8 of a measure)."""
    root, manifest = nyu_eval
    cfg, model, *_ = _tiny_pair(tiny_encoder, **_eval_kw(root, manifest))
    forward = make_eval_forward(model, cfg)
    single = run_online_eval(model, cfg, forward=forward, verbose=False)
    local = []

    def capture(vec):
        local.append(np.array(vec, copy=True))
        return np.stack([vec])

    for r in range(3):
        out = run_online_eval(model, cfg, EvalLoader(cfg, "online_eval", 3, r), forward,
                              verbose=False, process_info=(3, r), allgather_fn=capture)
        assert (out is None) == (r != 0)
    assert sum(int(round(v[9])) for v in local) == 5
    combined = run_online_eval(model, cfg, EvalLoader(cfg, "online_eval", 3, 0), forward,
                               verbose=False, process_info=(3, 0),
                               allgather_fn=lambda vec: np.stack([vec, *local[1:]]))
    np.testing.assert_allclose(combined, single, rtol=1e-6)
    # Without process_info and allgather_fn, the process group's: a gloo group
    # of one rank here (tests/test_torch_parallel.py runs two).
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        np.testing.assert_array_equal(allgather_vector(np.arange(10.0)),
                                      np.arange(10.0, dtype=np.float32)[None])
        np.testing.assert_array_equal(run_online_eval(model, cfg, forward=forward,
                                                      verbose=False), single)
    finally:
        dist.destroy_process_group()


def test_eval_forward_keeps_the_modes_and_serves_eval_mode(tiny_encoder):
    """Under bn_no_track_stats the train step keeps every BN in eval inside a
    train-mode model: the eval forward leaves each module's mode as it found
    it, and computes the eval-mode forward (bf16 autocast within bf16's
    rounding)."""
    cfg = Config(encoder=tiny_encoder, bts_size=128, bn_no_track_stats=True)
    model = state.set_bn_mode(bts.create_model(cfg), cfg)
    before = [m.training for m in model.modules()]
    assert any(before) and not all(before)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    focal = np.full(2, 518.8579, np.float32)
    got = make_eval_forward(model, cfg)(image, focal)
    assert [m.training for m in model.modules()] == before
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(image).permute(0, 3, 1, 2), torch.from_numpy(focal))
    assert got.dtype == torch.float32 and got.shape == (2, H, W)
    torch.testing.assert_close(got, want[4][:, 0], rtol=0, atol=0)
    bf16 = make_eval_forward(model, cfg.replace(compute_dtype="bfloat16"))(image, focal)
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, got, rtol=5e-2, atol=5e-2)


def test_fold_cache_follows_train_mode_bn_updates():
    """A train-mode forward updates the BN statistics in place without
    bumping their versions; the fused layer's fold must not keep the old
    statistics (the eval after a train step would fold stale ones)."""
    from bts_tpu_torch.models.encoders.densenet import DenseLayer
    from bts_tpu_torch.ops.fused_dense import fold_bn

    layer = DenseLayer(16, 8)
    first = layer.folded(torch.float32, False)
    assert layer.folded(torch.float32, False) is first  # cached
    layer.train()(torch.randn(2, 16, 5, 5))
    s1, b1 = layer.folded(torch.float32, False)[:2]
    n = layer.norm1
    want = fold_bn(n.weight.detach(), n.bias.detach(), n.running_mean, n.running_var, n.eps)
    assert torch.equal(s1, want[0]) and torch.equal(b1, want[1])
    assert not torch.equal(b1, first[1])


# ------------------------------------------------------------ offline eval


def _save_pth(path, model, step=0, age=120.0):
    """A port checkpoint file at ``path``, its mtime ``age`` seconds ago."""
    torch.save({"global_step": step, "model": model.state_dict()}, path)
    past = time.time() - age
    os.utime(path, (past, past))


def test_offline_ledger_and_watcher(tiny_encoder, nyu_eval):
    """test_eval_apps.py's ledger and watcher, with the port's .pth files:
    the maturity guard, the ledger, each pending step evaluated once (its
    measures those of run_online_eval on the same weights)."""
    root, manifest = nyu_eval
    cfg, model, *_ = _tiny_pair(tiny_encoder, **_eval_kw(root, manifest))
    ckpt_dir = root.parent / "ckpts"
    ckpt_dir.mkdir()
    for step in (100, 200):
        _save_pth(ckpt_dir / f"model-{step}", model, step, age=0.0)
    assert offline.pending_checkpoints(str(ckpt_dir), maturity_secs=3600) == {}
    assert sorted(offline.pending_checkpoints(str(ckpt_dir), maturity_secs=0.0)) == [100, 200]
    offline.append_ledger(str(ckpt_dir), 100)
    assert sorted(offline.pending_checkpoints(str(ckpt_dir), 0.0)) == [200]
    assert offline.read_ledger(str(ckpt_dir)) == [100]

    results = offline.evaluate_pending(cfg, str(ckpt_dir), maturity_secs=0.0, device=CPU)
    assert sorted(results) == [200] and offline.read_ledger(str(ckpt_dir)) == [100, 200]
    np.testing.assert_array_equal(results[200], run_online_eval(model, cfg, verbose=False))
    assert offline.evaluate_pending(cfg, str(ckpt_dir), maturity_secs=0.0, device=CPU) == {}


def test_eval_schedule_bounded(tmp_path, monkeypatch):
    """run_schedule with max_iterations stops and calls the evaluator each
    time (test_logging_schedule.py), on the device it was given."""
    calls = []
    monkeypatch.setattr(schedule, "evaluate_pending",
                        lambda cfg, writer=None, device=None: calls.append(device) or {})
    schedule.run_schedule(Config(log_directory=str(tmp_path)), interval_secs=0.01,
                          max_iterations=3, device=CPU)
    assert calls == [CPU] * 3


# ------------------------------------------------------------ the CLIs


def test_cli_eval_writes_the_ledger_once(tiny_encoder, nyu_eval, capsys):
    """``cli.eval --device cpu`` over a run dir with model-N files (no code
    snapshot): each step evaluated and written to the ledger; a second call
    evaluates nothing."""
    root, manifest = nyu_eval
    kw = _eval_kw(root, manifest)
    cfg, model, *_ = _tiny_pair(tiny_encoder, **kw)
    run_dir = root.parent / "logs" / "tiny"
    run_dir.mkdir(parents=True)
    for step in (3, 6):
        _save_pth(run_dir / f"model-{step}", model, step)
    argv = [f"--{k}={v}" for k, v in kw.items()] + [
        f"--encoder={tiny_encoder}", "--bts_size=128", f"--log_directory={run_dir.parent}",
        "--model_name=tiny", "--device", "cpu"]
    assert cli_eval.main(argv) == 0
    assert capsys.readouterr().out.count("Computing errors for 5 eval samples") == 2
    assert offline.read_ledger(str(run_dir)) == [3, 6]
    assert cli_eval.main(argv) == 0
    assert "Computing errors" not in capsys.readouterr().out
    assert offline.read_ledger(str(run_dir)) == [3, 6]


def test_cli_eval_runs_the_run_dirs_snapshot(tmp_path):
    """A run dir that holds a code snapshot is evaluated with the snapshot's
    code: ``python -m bts_tpu_torch.cli.eval`` re-executes from it (a marker
    planted in the snapshot's offline.py prints)."""
    from bts_tpu_torch.training.snapshot import snapshot_run

    root = tmp_path / "data"
    manifest = _write_nyu(root, [(H, W)] * 2)
    kw = dict(encoder="densenet121_bts", bts_size=128, log_directory=str(tmp_path / "logs"),
              model_name="snap", **_eval_kw(root, manifest))
    cfg = Config(**kw)
    run_dir = snapshot_run(cfg)
    with open(os.path.join(run_dir, "bts_tpu_torch", "evaluation", "offline.py"), "a") as f:
        f.write('\nprint("offline eval from the snapshot")\n')
    _save_pth(os.path.join(run_dir, "model-4"), bts.create_model(cfg), 4)
    out = subprocess.run([sys.executable, "-m", "bts_tpu_torch.cli.eval", "--device", "cpu",
                          *[f"--{k}={v}" for k, v in kw.items()]], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"Using model snapshot from {run_dir}" in out.stdout
    assert "offline eval from the snapshot" in out.stdout
    assert "Computing errors for 2 eval samples" in out.stdout
    assert offline.read_ledger(run_dir) == [4]


def test_cli_eval_with_pngs_prints_bts_tpus_table(tmp_path, capsys):
    """``cli.eval_with_pngs`` over dumped prediction pngs: bts_tpu's table."""
    root = tmp_path / "data"
    _write_nyu(root, [(48, 64)] * 3)
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(500, 9000, (48, 64), dtype=np.uint16)).save(
            raw / f"kitchen_0001_rgb_{i:05d}.png")
    argv = ["--pred_path", str(raw), "--gt_path", str(root), "--dataset", "nyu",
            "--min_depth_eval", "1e-3", "--max_depth_eval", "10"]
    assert cli_eval_with_pngs.main(argv) == 0
    got = capsys.readouterr().out
    jpng.eval_pngs(JConfig(pred_path=str(raw), gt_path=str(root), dataset="nyu",
                           min_depth_eval=1e-3, max_depth_eval=10.0))
    assert got == capsys.readouterr().out
    assert "Computing errors for 3 eval samples" in got


def test_cli_eval_schedule_takes_the_device(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(cli_eval_schedule, "run_schedule",
                        lambda cfg, writer=None, device=None: seen.update(cfg=cfg, device=device))
    assert cli_eval_schedule.main(["--log_directory", str(tmp_path), "--device", "cpu"]) == 0
    assert seen["device"] == CPU and seen["cfg"].log_directory == str(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_eval_schedule.main(["--log_directory", str(tmp_path)])


# ------------------------------------------------------------ the loop


def test_train_with_online_eval_saves_best_checkpoints(tiny_encoder, tmp_path, monkeypatch):
    """``train(..., max_steps)`` with --do_online_eval every step: no
    model-N, one model-{step}-best_{metric}_{value:.5f} per metric (the
    superseded ones deleted), and a fresh model on a best checkpoint
    reproduces the measures the loop logged at that step (rtol 1e-5).
    Resumed from a checkpoint, the step right after the load is not
    evaluated."""
    from bts_tpu_torch.training import loop

    root = tmp_path / "data"
    manifest = _write_nyu(root, [(2 * H, 2 * W)] * 4)
    logged = []
    real = loop.run_online_eval

    def recording(model, cfg, loader, forward):
        measures = real(model, cfg, loader, forward)
        logged.append(measures)
        return measures

    monkeypatch.setattr(loop, "run_online_eval", recording)
    cfg = Config(encoder=tiny_encoder, bts_size=128, batch_size=2, input_height=H,
                 input_width=W, log_directory=str(tmp_path / "logs"), model_name="tiny_run",
                 num_epochs=2, log_freq=1, save_freq=1, do_online_eval=True, eval_freq=1,
                 device_augment=True, **{k: v for k, v in _eval_kw(root, manifest).items()
                                         if k not in ("input_height", "input_width")})
    assert train(cfg, max_steps=2, device=CPU) == 2
    run_dir = tmp_path / "logs" / "tiny_run"
    assert checkpoint.list_step_checkpoints(str(run_dir)) == {}
    best = sorted(p.name for p in run_dir.iterdir() if "-best_" in p.name)
    assert sorted(name.split("-best_")[1].rsplit("_", 1)[0] for name in best) == sorted(EVAL_METRICS)
    assert len(logged) == 2
    for name in best:
        step = int(name.split("-")[1])
        metric, value = name.split("-best_")[1].rsplit("_", 1)
        assert float(value) == pytest.approx(logged[step - 1][EVAL_METRICS.index(metric)],
                                             abs=5e-6)
    step = int(best[0].split("-")[1])
    fresh = bts.create_model(cfg)
    fresh.load_state_dict(load_checkpoint(str(run_dir / best[0])), strict=True)
    np.testing.assert_allclose(run_online_eval(fresh, cfg, verbose=False), logged[step - 1],
                               rtol=1e-5)

    logged.clear()
    resumed = cfg.replace(checkpoint_path=str(run_dir / best[-1]))
    assert train(resumed, max_steps=int(best[-1].split("-")[1]) + 2, device=CPU) > 0
    assert len(logged) == 1
