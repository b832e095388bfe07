"""Data parallelism on the CPU (``bts_tpu_torch/parallel``): two gloo ranks,
started once for this file (``job``), against bts_tpu's jitted step over a
2-device mesh and against the port's single-process step on the same global
batch; online eval over two ranks against one; the replicated forward; the
global BN at world 1 against nn.BatchNorm2d; the launcher's environments and
devices; ``cli.train --device cpu --num_devices 2``.

The ranks run tests/torch_parallel_ranks.py and return their results; the
comparisons run here."""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bts_tpu.models import bts as jbts
from bts_tpu.parallel.mesh import make_mesh, shard_batch
from bts_tpu.training import optim as joptim
from bts_tpu.training import state as jstate
from bts_tpu_torch.cli import train as cli_train
from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.online import run_online_eval
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from bts_tpu_torch.parallel import launch, mesh
from bts_tpu_torch.parallel.inference import make_sharded_forward
from bts_tpu_torch.parallel.sync_bn import GlobalBatchNorm2d, convert_global_bn
from bts_tpu_torch.training import optim, state
from bts_tpu_torch.training.checkpoint import list_step_checkpoints

import test_torch_model
import torch_parallel_ranks as ranks
from test_torch_eval_online import _eval_kw, _write_nyu
from test_torch_model import tiny_encoder  # noqa: F401 (fixture)
from test_torch_train_step import _Float64Numpy
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_train_helpers import H, W, cfgs, tiny_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"bn_train": False, "bn_no_track": True}
FOCAL = 518.8579


def _train_kw(bn_no_track_stats, **kw):
    """test_torch_train_step.py's fields at a global batch of 4."""
    return dict(encoder=ranks.TINY, dataset="nyu", max_depth=10.0, bts_size=128,
                fast_tail=False, lpg_impl="pallas", learning_rate=1e-4, weight_decay=1e-2,
                adam_eps=1e-3, batch_size=4, input_height=H, input_width=W,
                bn_no_track_stats=bn_no_track_stats, **kw)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs of every check, and one 2-rank gloo job over them."""
    tmp = tmp_path_factory.mktemp("parallel")
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(jbts.ENCODERS, ranks.TINY, (test_torch_model.tiny_jax, ranks.TINY_CHANNELS))
        _, jcfg = cfgs(**_train_kw(False))
        _, params, stats = tiny_variables(ranks.TINY, jcfg, seed=3)
    # Copies: bts_tpu's jitted step donates its state's buffers.
    sd = {k: v.clone() for k, v in state_dict_from_flax(params, stats).items()}
    rng = np.random.default_rng(4)
    # Raw frames larger than the crop: --device_augment crops, flips, jitters.
    batches = [{"image": rng.uniform(0.0, 1.0, (4, H + 16, W + 24, 3)).astype(np.float32),
                "depth": rng.uniform(0.0, 10.0, (4, H + 16, W + 24, 1)).astype(np.float32),
                "focal": np.full(4, FOCAL, np.float32)} for _ in range(2)]
    root = tmp / "eval"
    ecfg = Config(encoder=ranks.TINY, bts_size=128, **_eval_kw(root, _write_nyu(root, [(H, W)] * 5)))
    inputs = {
        "train": {m: (Config(**_train_kw(f, device_augment=True)), sd, batches)
                  for m, f in MODES.items()},
        "eval": (ecfg, sd),
        "remat": (Config(**_train_kw(False, device_augment=True, remat=True,
                                     remat_policy="conv", remat_scope="all")), sd, batches),
        "serve": {"image": rng.normal(size=(2, 3, H, W)).astype(np.float32),
                  "focal": np.full(2, FOCAL, np.float32)},
    }
    path = tmp / "inputs.pt"
    torch.save(inputs, path)
    results = launch.spawn(functools.partial(ranks.parallel_job, str(path)), Config(), 2,
                           devices=["cpu", "cpu"])
    return {**inputs, "params": params, "stats": stats, "results": results}


def _bts_tpu_mesh_steps_float64(cfg, params, stats, batches):
    """bts_tpu's jit_train_step over make_mesh(2), in float64 (its BN
    statistics too, as test_torch_train_step.py evaluates its gradient), on
    the global batches as the port's augmentation gives them (device_augment
    off on bts_tpu's side: jax.random draws other parameters; the
    augmentations themselves are held equal by tests/test_torch_train_data.py)."""
    from bts_tpu.models import layers as jlayers

    _, jcfg = cfgs(**_train_kw(cfg.bn_no_track_stats, compute_dtype="float64"))
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jlayers, "jnp", _Float64Numpy())
            jmodel = jbts.create_model(jcfg)
            p64 = f64(params)
            tx, _ = joptim.create_optimizer(jcfg, p64, 50)
            mesh2 = make_mesh(2)
            jst = jstate.create_train_state(p64, f64(stats), tx, mesh=mesh2)
            jstep = jstate.jit_train_step(jstate.make_train_step(jmodel, tx, jcfg), mesh2)
            losses = []
            for s, b in enumerate(batches):
                image, depth = state.device_view(
                    {k: torch.from_numpy(v) for k, v in b.items()}, cfg, s)
                jb = {"image": image.permute(0, 2, 3, 1).numpy(), "depth": depth.numpy(),
                      "focal": b["focal"]}
                jst, metrics = jstep(jst, shard_batch(f64(jb), mesh2))
                losses.append(float(metrics["loss"]))
            return losses, state_dict_from_flax(jax.tree.map(np.asarray, jst.params),
                                                jax.tree.map(np.asarray, jst.batch_stats))
    finally:
        jax.config.update("jax_enable_x64", False)


def _float64_steps(cfg, sd, batches):
    """The port's single-process steps in float64: (step 1's gradients, the
    state dict after the steps)."""
    model = bts.create_model(cfg)
    model.load_state_dict(sd, strict=True)
    model = model.double()
    opt, _ = optim.create_optimizer(cfg, model, 50)
    st = state.TrainState(model, opt)
    step = state.make_train_step(cfg)
    grads = None
    for b in batches:
        step(st, {k: torch.from_numpy(v).double() for k, v in b.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_step_is_the_global_batch_step(tiny_encoder, job, mode):
    """Two gloo ranks, 2 samples each of a global batch of 4, two steps with
    --device_augment, against bts_tpu's jitted step over a 2-device mesh and
    the port's single-process step on the global batch, both in float64: the
    loss on both ranks at rtol 1e-5 (and of the port's f32 single-process
    step), parameters and BN statistics after the steps at atol 1e-5 (the two
    ranks' equal), step 1's gradient of every leaf within 1e-4 of its largest
    magnitude (test_torch_train_step.py's tolerances). The yardsticks are
    float64 because on this batch the f32 single-process steps are not within
    them: with BN trained, the port's f32 gradient (nn.BatchNorm2d) is off by
    up to 7e-2 of that in the Dense-ASPP BNs, and bts_tpu's and its state by
    1.9e-5 after two steps, where the ranks' global BN (its sums about the
    mean) stays within 3e-5 and 4e-7."""
    cfg, sd, batches = job["train"][mode]
    losses = ranks.train_steps(cfg, sd, batches)[0]
    grads, single = _float64_steps(cfg, sd, batches)
    want_losses, want = _bts_tpu_mesh_steps_float64(cfg, job["params"], job["stats"], batches)
    r0, r1 = (r[mode] for r in job["results"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        assert r["grads"].keys() == grads.keys()
        for n, g in grads.items():
            scale = float(g.abs().max())
            np.testing.assert_allclose(r["grads"][n].double().numpy(), g.numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=n)
    for n, v in r0["state"].items():
        torch.testing.assert_close(r1["state"][n], v, rtol=0, atol=0, msg=n)
        np.testing.assert_allclose(v.double().numpy(), single[n].double().numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)
        if n in want and not n.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.double().numpy(), want[n].double().numpy(), rtol=0,
                                       atol=1e-5, err_msg=n)
    moved = [n for n in sd if n.endswith("running_mean") and not torch.equal(r0["state"][n], sd[n])]
    assert bool(moved) == (mode == "bn_train")


def test_two_rank_remat_step_equals_two_rank_step(job):
    """The two ranks' steps with --remat --remat_scope all (policy conv)
    against their steps without, bit for bit: the losses, step 1's
    gradients, every parameter and BN buffer after the two steps. The
    recompute replays the global BN's all-reduces inside the backward, in the
    same order on both ranks, and gets the forward's statistics back; it
    leaves the running statistics as the forward left them."""
    for r in job["results"]:
        got, want = r["remat"], r["bn_train"]
        assert got["losses"] == want["losses"]
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in want["grads"].items():
            assert torch.equal(got["grads"][n], g), n
        for n, v in want["state"].items():
            assert torch.equal(got["state"][n], v), n


def test_wrap_broadcasts_rank_0s_parameters_and_buffers(job):
    """bts_tpu's replicate_tree: the ranks seeded alike, rank 1's parameters
    and buffers perturbed before the wrap; after it both hold rank 0's."""
    sd = job["train"]["bn_train"][1]
    r0, r1 = (r["wrapped"] for r in job["results"])
    for n, v in sd.items():
        torch.testing.assert_close(r0[n], v, rtol=0, atol=0, msg=n)
        torch.testing.assert_close(r1[n], v, rtol=0, atol=0, msg=n)


def test_two_rank_online_eval_equals_single(tiny_encoder, job):
    """bts_tpu's test_online_eval_simulated_3process_equals_single made real:
    two ranks over 5 frames (3 + 2 by the exact-count shards, sent as f32 as
    bts_tpu sends them) against one process, rtol 2e-5 (the f32 sums and the
    CPU's batch-size-dependent convolution rounding); only rank 0 returns."""
    ecfg, sd = job["eval"]
    model = bts.create_model(ecfg)
    model.load_state_dict(sd, strict=True)
    single = run_online_eval(model, ecfg, verbose=False)
    r0, r1 = job["results"]
    assert r1["eval"] is None
    np.testing.assert_allclose(r0["eval"], single, rtol=2e-5)
    assert [r["eval_sent"].dtype for r in job["results"]] == [np.float32] * 2
    assert [int(r["eval_sent"][9]) for r in job["results"]] == [3, 2]


def test_sharded_forward_matches_the_single_forward(tiny_encoder, job):
    """make_sharded_forward on [cpu, cpu]: the batch of 4 in two parts of 2,
    each the eval forward of a replica copied once; a batch of 3 raises. A
    replica of a model whose BN were made global on the ranks (the ranks'
    ``serve``) gives that model's eval forward."""
    ecfg, sd = job["eval"]
    model = bts.create_model(ecfg)
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(4, 3, H, W)).astype(np.float32))
    f = torch.full((4,), FOCAL)
    fwd = make_sharded_forward(model, ["cpu", "cpu"], ecfg)
    with torch.no_grad():
        model.train()  # the replicas are copies in eval mode, made already
        want = bts.create_model(ecfg).eval()
        want.load_state_dict(sd)
        want = want(x, f)[4][:, 0]
        for p in model.parameters():
            p.add_(1.0)
    parts = fwd(x, f)
    assert [tuple(p.shape) for p in parts] == [(2, H, W)] * 2
    torch.testing.assert_close(torch.cat(parts), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="a batch of 3 does not split over 2 devices"):
        fwd(x[:3], f[:3])

    cfg = job["train"]["bn_train"][0]
    trained = bts.create_model(cfg)
    trained.load_state_dict(job["results"][0]["bn_train"]["state"])
    s = job["serve"]
    with torch.no_grad():
        want = trained.eval()(torch.from_numpy(s["image"]), torch.from_numpy(s["focal"]))
    for r in job["results"]:
        torch.testing.assert_close(r["serve"], want[4][:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("momentum,shape", [(0.1, (4, 6, 5, 7)), (None, (1, 3, 2, 2))])
def test_global_bn_at_world_1_is_batchnorm2d(momentum, shape):
    """GlobalBatchNorm2d with no group against nn.BatchNorm2d: the forward,
    the input's and the affine parameters' gradients and the running
    statistics over two train-mode calls, the eval forward, and the same
    state-dict keys. The inputs sit far from zero (mean 50, spread 0.5): the
    sums about the shift keep the variance where a mean of squares about
    zero would lose it in f32."""
    rng = np.random.default_rng(0)
    c = shape[1]
    ref = nn.BatchNorm2d(c, eps=1e-5, momentum=momentum)
    got = GlobalBatchNorm2d(c, eps=1e-5, momentum=momentum)
    with torch.no_grad():
        for m in (ref, got):
            m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(rng.normal(size=c).astype(np.float32)))
    assert got.state_dict().keys() == ref.state_dict().keys()
    got.load_state_dict(ref.state_dict())
    for _ in range(2):
        x = torch.from_numpy((50 + 0.5 * rng.normal(size=shape)).astype(np.float32))
        up = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        outs = []
        for m in (ref, got):
            xi = x.clone().requires_grad_(True)
            m.zero_grad()
            y = m.train()(xi)
            (y * up).sum().backward()
            outs.append((y.detach(), xi.grad, m.weight.grad, m.bias.grad))
        for g, w in zip(outs[1], outs[0]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        for n, v in ref.state_dict().items():
            torch.testing.assert_close(got.state_dict()[n], v, rtol=1e-5, atol=1e-6, msg=n)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    torch.testing.assert_close(got.eval()(x), ref.eval()(x), rtol=1e-5, atol=1e-5)
    assert convert_global_bn(ref) is ref and type(ref) is nn.BatchNorm2d  # no group: no swap


def test_launcher_environments_decision_table():
    """The counterpart of test_multihost_env_decision_table: the decision is
    read from the environment alone, and initialize runs exactly when the
    table says so."""
    reason = mesh._multihost_env_reason
    assert reason({}) is None
    assert reason({"WORLD_SIZE": "4", "RANK": "1", "LOCAL_RANK": "1"}) == "world_size"
    assert reason({"WORLD_SIZE": "1"}) is None
    assert reason({"SLURM_NTASKS": "8"}) == "slurm_ntasks"
    assert reason({"SLURM_JOB_NUM_NODES": "4"}) == "slurm_job_num_nodes"
    assert reason({"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "1"}) is None
    assert reason({"OMPI_COMM_WORLD_SIZE": "2"}) == "ompi_comm_world_size"
    assert reason({"SLURM_JOB_NUM_NODES": "weird"}) is None
    # bts_tpu's TPU launchers start no torch ranks.
    for key, value in (("COORDINATOR_ADDRESS", "h:1234"), ("TPU_WORKER_HOSTNAMES", "a,b"),
                       ("CLOUD_TPU_TASK_ID", "0")):
        assert reason({key: value}) is None
    assert mesh.env_ranks({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"}) == (4, 3, 1)
    assert mesh.env_ranks({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"}) \
        == (8, 5, 1)
    assert mesh.env_ranks({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
                           "OMPI_COMM_WORLD_LOCAL_RANK": "1"}) == (2, 1, 1)
    assert mesh.env_ranks({}) == (1, 0, 0)
    calls = []
    assert not mesh.maybe_init_distributed({}, initialize_fn=lambda: calls.append(1))
    assert not mesh.maybe_init_distributed({"WORLD_SIZE": "1"}, lambda: calls.append(1))
    assert calls == []
    assert mesh.maybe_init_distributed({"WORLD_SIZE": "2"}, lambda: calls.append(1))
    assert calls == [1]
    assert mesh.process_shard_info() == (1, 0)



def test_launcher_rank_takes_the_device_flag(monkeypatch):
    """Under a launcher cli.train passes its ``--device``: ``cpu`` joins the
    group over gloo on the CPU; the default is the local rank's card, and a
    rank with no card raises naming ``--device cpu`` (as cli.test does)
    rather than train on the CPU unasked."""
    env = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}
    groups = []
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: groups.append((backend, kw["world_size"],
                                                             kw["rank"])))
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    assert mesh.env_device("cpu", env) == torch.device("cpu")
    assert mesh.maybe_init_distributed(env, device="cpu")
    assert groups == [("gloo", 2, 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.env_device("", env) == torch.device("cuda:1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.env_device("", env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(["--mode", "train"])
    assert groups == [("gloo", 2, 1)]  # no group was joined

def test_local_slice_is_the_ranks_block_of_the_global_batch():
    batch = {"image": np.arange(8).reshape(4, 2), "focal": np.arange(4.0)}
    got = [mesh.local_slice(batch, 2, r) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([g["image"] for g in got]), batch["image"])
    np.testing.assert_array_equal(got[1]["focal"], [2.0, 3.0])
    with pytest.raises(ValueError, match="a batch of 4 does not split over 3 ranks"):
        mesh.local_slice(batch, 3, 0)


def test_more_ranks_than_cards_raise():
    """Never fewer ranks than asked for: N above the visible cards raises,
    naming both numbers (this host has none)."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"2 ranks asked for, but this host has {cards} CUDA"):
        launch.spawn(ranks.preempted_train, Config(), 2)
    with pytest.raises(ValueError, match=f"{cards + 2} ranks asked for"):
        launch.rank_devices("", cards + 2)
    with pytest.raises(ValueError, match="2 ranks asked for"):
        cli_train.main(["--mode", "train", "--num_devices", "2"])
    assert launch.rank_devices("cpu", 0) == ["cpu"]
    assert launch.rank_devices("cpu", 3) == ["cpu"] * 3
    assert launch.rank_devices("cuda:0,cuda:0", 0) == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="one card a rank"):
        launch.spawn(ranks.preempted_train, Config(), 2, devices=["cuda:0", "cuda:0"],
                     backend="nccl")


def test_cli_train_on_two_cpu_ranks(tmp_path):
    """``cli.train --device cpu --num_devices 2``: 8 NYU 480x640 frames, a
    global batch of 4, one epoch: 2 steps on two gloo ranks. One run dir,
    written by rank 0 (each step logged once); ``model-2`` holds plain names
    (no DDP ``module.``) and loads into a single-process model."""
    root = tmp_path / "data"
    manifest = _write_nyu(root, [(480, 640)] * 8)
    args = tmp_path / "args.txt"
    args.write_text("\n".join([
        "--mode train", "--encoder mobilenetv2_bts", "--bts_size 128", "--dataset nyu",
        f"--data_path {root}", f"--gt_path {root}", f"--filenames_file {manifest}",
        "--batch_size 4", "--num_epochs 1", "--input_height 64", "--input_width 96",
        "--max_depth 10", "--log_freq 1", "--save_freq 2", "--device_augment",
        f"--log_directory {tmp_path / 'logs'}", "--model_name dp_run"]) + "\n")
    out = subprocess.run([sys.executable, "-m", "bts_tpu_torch.cli.train", "@" + str(args),
                          "--device", "cpu", "--num_devices", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    steps = re.findall(r"^\[epoch\]\[s/s_per_e/gs\]: \[0\]\[\d+/2/(\d+)\]", out.stdout, re.M)
    assert steps == ["1", "2"]
    assert out.stdout.count("Total number of parameters") == 1
    assert sorted(os.listdir(tmp_path / "logs")) == ["dp_run"]
    run_dir = tmp_path / "logs" / "dp_run"
    assert sorted(list_step_checkpoints(str(run_dir))) == [2]
    saved = load_checkpoint(str(run_dir / "model-2"))
    assert not [k for k in saved if k.startswith("module.")]
    model = bts.create_model(Config(encoder="mobilenetv2_bts", bts_size=128, dataset="nyu"))
    model.load_state_dict(saved, strict=True)
