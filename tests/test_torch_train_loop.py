"""The port's checkpoints (save, restore, resume, a reference .pth,
--retrain, pruning, the best tracker against bts_tpu's) and its train loop
and CLI on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.training import checkpoint as jckpt
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.training import checkpoint, optim, state
from bts_tpu_torch.training.loop import train
from bts_tpu_torch.training.lr import polynomial_decay_host

from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from torch_train_helpers import H, W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ checkpoints


def _small_state(tiny_encoder, **kw):
    cfg = Config(encoder=tiny_encoder, bts_size=128, learning_rate=1e-3, adam_eps=1e-3, **kw)
    model = bts.create_model(cfg)
    opt, schedule = optim.create_optimizer(cfg, model, 100)
    return cfg, state.TrainState(model, opt), schedule


def _fake_steps(st, n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for _, p in st.optimizer.named_params():
            p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        st.optimizer.step()
        st.step += 1


def test_checkpoint_resume_continues_step_and_lr(tiny_encoder, tmp_path):
    cfg, st, schedule = _small_state(tiny_encoder)
    _fake_steps(st, 3)
    best = checkpoint.BestTracker()
    best.update(np.arange(9, dtype=np.float64), 3)
    path = str(tmp_path / "model-3")
    checkpoint.save_checkpoint(path, st, best)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"global_step", "model", "optimizer", *checkpoint.BEST_KEYS}

    cfg2, fresh, _ = _small_state(tiny_encoder, seed=7, checkpoint_path=path)
    fresh, best2 = checkpoint.restore_training_start(cfg2, fresh, checkpoint.BestTracker())
    assert fresh.step == 3 and fresh.optimizer.applied_lr() == schedule(3).item()
    np.testing.assert_array_equal(best2.steps, best.steps)
    for (n, a), (_, b) in zip(st.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, s in st.optimizer.state.items():
        assert all(torch.equal(s[k], fresh.optimizer.state[n][k]) for k in s)
    _fake_steps(st, 1, seed=9)
    _fake_steps(fresh, 1, seed=9)
    for (n, a), (_, b) in zip(st.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n

    # --retrain restarts the step and the LR, keeping the weights.
    cfg3, again, _ = _small_state(tiny_encoder, checkpoint_path=path, retrain=True)
    again, _ = checkpoint.restore_training_start(cfg3, again, checkpoint.BestTracker())
    assert again.step == 0 and again.optimizer.applied_lr() == schedule(0).item()


def test_reference_pth_restores_with_a_fresh_optimizer(tiny_encoder, tmp_path):
    """A reference trainer's save: DDP-prefixed weights, torch.optim.AdamW
    state, numpy best_eval_steps."""
    cfg, st, schedule = _small_state(tiny_encoder)
    ref_opt = torch.optim.AdamW(st.model.parameters(), lr=1e-4)
    path = str(tmp_path / "model-1200")
    torch.save({"global_step": 1200,
                "model": {"module." + k: v for k, v in st.model.state_dict().items()},
                "optimizer": ref_opt.state_dict(),
                "best_eval_measures_lower_better": torch.zeros(6) + 1e3,
                "best_eval_measures_higher_better": torch.zeros(3),
                "best_eval_steps": np.zeros(9, dtype=np.int32)}, path)
    cfg2, fresh, _ = _small_state(tiny_encoder, seed=5, checkpoint_path=path)
    fresh, best = checkpoint.restore_training_start(cfg2, fresh, checkpoint.BestTracker())
    assert fresh.step == 1200 and not fresh.optimizer.state
    assert all(g["count"] == 0 and g["schedule_count"] == 1200
               for g in fresh.optimizer.groups.values())
    assert fresh.optimizer.applied_lr() == schedule(1200).item()
    assert best.steps.tolist() == [0] * 9
    for k, v in st.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v)


def test_prune_and_best_names(tmp_path):
    for step in (10, 20, 30, 40):
        (tmp_path / f"model-{step}").write_bytes(b"x")
    name = checkpoint.best_checkpoint_name(30, "d1", 0.912345)
    assert name == jckpt.best_checkpoint_name(30, "d1", 0.912345)
    (tmp_path / name).write_bytes(b"x")
    checkpoint.prune_step_checkpoints(str(tmp_path), 2)
    assert sorted(checkpoint.list_step_checkpoints(str(tmp_path))) == [30, 40]
    assert (tmp_path / name).exists()
    checkpoint.remove_old_best(str(tmp_path), 30, "d1", 0.912345)
    assert not (tmp_path / name).exists()


def test_best_tracker_matches_bts_tpu():
    rng = np.random.default_rng(8)
    got, want = checkpoint.BestTracker(), jckpt.BestTracker()
    assert checkpoint.EVAL_METRICS == list(__import__(
        "bts_tpu.evaluation.metrics", fromlist=["EVAL_METRICS"]).EVAL_METRICS)
    for step in range(1, 8):
        measures = rng.uniform(0, 2, 9)
        assert got.update(measures, step * 10) == want.update(measures, step * 10)
    for a, b in zip(got.to_dict().values(), want.to_dict().values()):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = checkpoint.BestTracker.from_dict(got.to_dict())
    np.testing.assert_array_equal(back.lower, want.lower)
    np.testing.assert_array_equal(back.steps, want.steps)


# ------------------------------------------------------------ the loop


def _frames(root, n=4, h=H * 2, w=W * 2):
    scene = root / "s1"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(3)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            scene / f"rgb_{i:05d}.jpg")
        Image.fromarray(rng.integers(500, 9000, (h, w), dtype=np.uint16)).save(
            scene / f"sync_depth_{i:05d}.png")
        lines.append(f"s1/rgb_{i:05d}.jpg s1/sync_depth_{i:05d}.png 518.8579")
    manifest = root / "train.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


def _loop_cfg(tiny_encoder, tmp_path, **kw):
    root = tmp_path / "data"
    manifest = _frames(root)
    base = dict(encoder=tiny_encoder, dataset="kitti", bts_size=128, batch_size=2,
                input_height=H, input_width=W, data_path=str(root), gt_path=str(root),
                filenames_file=str(manifest), log_directory=str(tmp_path / "logs"),
                model_name="tiny_run", num_epochs=2, log_freq=1, save_freq=1000,
                device_augment=True, model_flavor="pt", normalization="imagenet")
    base.update(kw)
    return Config(**base)


def test_train_loop_end_to_end(tiny_encoder, tmp_path, capsys):
    cfg = _loop_cfg(tiny_encoder, tmp_path, save_freq=2)
    assert train(cfg, max_steps=2, device=torch.device("cpu")) == 2
    run_dir = tmp_path / "logs" / "tiny_run"
    assert (run_dir / "arguments.txt").exists()
    assert (run_dir / "bts_tpu_torch" / "training" / "loop.py").exists()
    assert sorted(checkpoint.list_step_checkpoints(str(run_dir))) == [2]
    out = capsys.readouterr().out
    assert "[epoch][s/s_per_e/gs]: [0][1/2/2], lr: " in out and "examples/s: " in out


def test_train_loop_aborts_on_nan(tiny_encoder, tmp_path, monkeypatch, capsys):
    real = state.silog_loss
    monkeypatch.setattr(state, "silog_loss", lambda *a: real(*a) * float("nan"))
    cfg = _loop_cfg(tiny_encoder, tmp_path, log_directory="")
    assert train(cfg, max_steps=2, device=torch.device("cpu")) == -1
    assert "NaN in loss occurred. Aborting training." in capsys.readouterr().out


@pytest.mark.parametrize("flag,item", [({"num_devices": 4}, "item 10")])
def test_train_refuses_what_is_not_ported(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        train(Config(**flag), device=torch.device("cpu"))


def _cli_train(args, *extra):
    # One intra-op thread: the test workers share the machine's cores, and
    # PyTorch's default of a thread per core oversubscribes them.
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "bts_tpu_torch.cli.train", "@" + str(args),
                           "--device", "cpu", *extra], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)


def test_cli_train_runs_two_steps_on_the_cpu_and_resumes_from_its_snapshot(tmp_path):
    """``python -m bts_tpu_torch.cli.train <argfile> --device cpu``: 4 frames,
    batch 2, one epoch: 2 steps and a model-2 checkpoint that loads into a
    fresh model. Resuming from it (two epochs) runs the run's code snapshot
    and continues with steps 3 and 4 at the schedule's LR."""
    root = tmp_path / "data"
    manifest = _frames(root, h=480, w=640)
    args = tmp_path / "args.txt"
    args.write_text("\n".join([
        "--mode train", "--encoder densenet121_bts", "--bts_size 128", "--dataset nyu",
        f"--data_path {root}", f"--gt_path {root}", f"--filenames_file {manifest}",
        "--batch_size 2", "--num_epochs 1", "--input_height 64", "--input_width 96",
        f"--log_directory {tmp_path / 'logs'}", "--model_name cli_run", "--save_freq 2",
        "--adam_eps 1e-3", "--device_augment", "--do_random_rotate",
    ]) + "\n")
    out = _cli_train(args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[epoch][s/s_per_e/gs]") == 2
    run_dir = tmp_path / "logs" / "cli_run"
    ckpt = run_dir / "model-2"
    assert ckpt.is_file() and (run_dir / "bts_tpu_torch" / "cli" / "train.py").is_file()
    model = bts.create_model(Config(encoder="densenet121_bts", bts_size=128))
    from bts_tpu_torch.models.convert import load_checkpoint

    model.load_state_dict(load_checkpoint(str(ckpt)), strict=True)

    out = _cli_train(args, "--checkpoint_path", str(ckpt), "--num_epochs", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"Using model snapshot from {run_dir}" in out.stdout
    assert f"Loaded checkpoint '{ckpt}' (global_step 2)" in out.stdout
    steps = [ln for ln in out.stdout.splitlines() if ln.startswith("[epoch]")]
    lr = polynomial_decay_host(1e-4, 1e-5, 4)
    assert steps == [f"[epoch][s/s_per_e/gs]: [1][{s - 3}/2/{s}], lr: {lr(s):.12f}, "
                     + ln.split(", ")[-1] for s, ln in zip((3, 4), steps)]


def test_sigterm_checkpoints_and_stops(tiny_encoder, tmp_path, monkeypatch):
    """A termination signal latched during step 1: the loop saves model-1 and
    returns 1."""
    from bts_tpu_torch.training import loop

    class Requested(loop.PreemptionGuard):
        requested = True

    monkeypatch.setattr(loop, "PreemptionGuard", Requested)
    cfg = _loop_cfg(tiny_encoder, tmp_path)
    assert train(cfg, max_steps=2, device=torch.device("cpu")) == 1
    assert sorted(checkpoint.list_step_checkpoints(str(tmp_path / "logs" / "tiny_run"))) == [1]


def test_profile_steps_write_a_trace(tiny_encoder, tmp_path, monkeypatch):
    """--profile_steps: a torch.profiler trace of that many steps from the
    profile start step (0 here) into --profile_dir."""
    from bts_tpu_torch.training import loop

    monkeypatch.setattr(loop, "PROFILE_START_STEP", 0)
    cfg = _loop_cfg(tiny_encoder, tmp_path, log_directory="", profile_steps=1,
                    profile_dir=str(tmp_path / "trace"))
    assert train(cfg, max_steps=2, device=torch.device("cpu")) == 2
    assert [p.suffix for p in (tmp_path / "trace").iterdir()] == [".json"]


def test_pretrained_model_warm_starts_by_name_and_shape(tiny_encoder, tmp_path):
    """--pretrained_model loads the tensors whose names and shapes match and
    leaves the rest as seeded."""
    from bts_tpu_torch.training.loop import warm_start

    source = bts.create_model(Config(encoder=tiny_encoder, bts_size=128, seed=3))
    state_dict = {"module." + k: v for k, v in source.state_dict().items()
                  if not k.startswith("decoder.")}
    state_dict["module.encoder.base_model.conv0.weight"] = torch.zeros(1, 2, 3)  # other shape
    state_dict["module.not.in.the.model"] = torch.zeros(4)
    torch.save({"model": state_dict}, tmp_path / "pretrained.pth")
    model = bts.create_model(Config(encoder=tiny_encoder, bts_size=128))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    warm_start(model, str(tmp_path / "pretrained.pth"))
    for k, v in model.state_dict().items():
        loaded = k.startswith("encoder.") and k != "encoder.base_model.conv0.weight"
        assert torch.equal(v, source.state_dict()[k] if loaded else before[k]), k
