"""The port's benchmark tools (``bts_tpu_torch/tools/bench*.py``) against the
repo's JAX scripts (``bench.py``, ``scripts/bench_{train,zoo,lpg}.py``) on the
CPU: the timed function is ``bts_tpu``'s, the inputs are the scripts' draws,
the knobs and the printed keys are the scripts', and no tool falls back to the
CPU unasked.

The JAX scripts are run with their heavy parts replaced (model building,
compiling, timing), up to the point where their inputs or their Config exist,
so that what they would run is read from the scripts themselves.
"""

import ast
import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.config import Config as JaxConfig
from bts_tpu.models import bts as jbts
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.tools import bench, bench_lpg, bench_train, bench_zoo, benchtools

from test_torch_model import TINY, TINY_CHANNELS, tiny_jax, tiny_torch
from torch_threads import one_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
TINY2 = "tiny2_densenet_bts"
CPU = torch.device("cpu")
SMALL = ["--device", "cpu", "--height", str(H), "--width", str(W), "--batch", "2",
         "--iters", "2", "--delay", "1"]


class Stop(Exception):
    """Raised by a stand-in to end a JAX script once what it would run exists."""


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{Path(name).stem}", ROOT / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_keys(name):
    """The key sets of the dict literals a script passes to json.dumps."""
    tree = ast.parse((ROOT / name).read_text())
    return [
        {k.value for k in node.args[0].keys}
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
        and isinstance(node.args[0], ast.Dict)
    ]


def printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.fixture
def tiny_encoders(monkeypatch):
    """The tiny DenseNet of test_torch_model under two names, in both zoos."""
    for name in (TINY, TINY2):
        monkeypatch.setitem(jbts.ENCODERS, name, (tiny_jax, TINY_CHANNELS))
        monkeypatch.setitem(bts.ENCODERS, name, (tiny_torch, TINY_CHANNELS))
    return TINY, TINY2


def seeded_variables(jmodel, rng):
    """bts_tpu variables drawn from ``rng`` into the shapes of its init (traced,
    not compiled): kernels at 1/sqrt(fan-in), BN scales and variances in
    [0.5, 1.5), biases and means about 0."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, H, W, 3)), jnp.full((1,), 518.8579), train=False))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_bench_forward_is_bts_tpus(tiny_encoders):
    """The function tools/bench.py times, depth.sum() at batch 2 in f32, on
    bts_tpu's weights carried over by state_dict_from_flax, against
    bench.py's jitted forward: ``model.apply(..., train=False)[4]`` summed.
    The 12288 depths are positive, so the sum's relative error is at most the
    largest of the elements', which test_model_matches_bts_tpu holds to rtol
    1e-3 (they differ near 1e-6): rtol 1e-4 on the sum."""
    jmodel = jbts.create_model(JaxConfig(encoder=TINY, dataset="nyu", max_depth=10.0,
                                         bts_size=128))
    variables = seeded_variables(jmodel, np.random.default_rng(2))
    image = np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32)
    focal = np.full((2,), 518.8579, np.float32)
    forward = jax.jit(lambda v, im, f: jnp.sum(jmodel.apply(v, im, f, train=False)[4]))
    want = float(forward(variables, image, focal))

    cfg = bench.bench_config(TINY).replace(compute_dtype="float32", bts_size=128)
    model = bts.create_model(cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]),
                          strict=True)
    (ours,) = benchtools.seeded_images(2, H, W, CPU, n=1)
    got = bench.make_forward(model, cfg, CPU)(ours, benchtools.focal(2, CPU))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)


def test_bench_config_is_bench_pys(monkeypatch):
    """bench.py's Config, read where it builds its model."""
    import bts_tpu.models.bts as jmodels

    def create_model(cfg):
        raise Stop(cfg)

    monkeypatch.setattr(jmodels, "create_model", create_model)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(Stop) as stop:
        load_script("bench.py").main()
    assert dataclasses.asdict(stop.value.args[0]) == dataclasses.asdict(bench.bench_config())


def test_images_are_the_scripts_draws(monkeypatch):
    """bench_zoo.py's two images (bench.py draws them alike), read where it
    hands them to jnp, equal the tools' inputs once moved back to NHWC."""
    drawn = []

    def full(*args, **kwargs):
        raise Stop

    script = load_script("scripts/bench_zoo.py")
    monkeypatch.setattr(script, "jnp", types.SimpleNamespace(asarray=drawn.append, full=full,
                                                                float32=np.float32))
    monkeypatch.setattr(sys, "argv", ["bench_zoo.py", "--height", "32", "--width", "48",
                                      "--batch", "3"])
    with pytest.raises(Stop):
        script.main()
    ours = benchtools.seeded_images(3, 32, 48, CPU)
    assert len(drawn) == len(ours) == 2
    for want, got in zip(drawn, ours):
        assert got.shape == (3, 3, 32, 48)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("flags", [
    [],
    ["--dataset", "kitti", "--bf16_moments"],
    ["--no_device_augment", "--no_fast_tail", "--remat", "--remat_policy", "full",
     "--remat_scope", "all"],
])
def test_bench_train_config_and_batches_are_the_scripts(monkeypatch, flags):
    """scripts/bench_train.py's Config, field for field, and its two host
    batches, read where it shards them, at a small size; with --remat the
    tool's Config and model carry the three remat values."""
    import bts_tpu.config as jconfig
    import bts_tpu.models.bts as jmodels
    import bts_tpu.parallel.mesh as jmesh
    import bts_tpu.training.optim as joptim
    import bts_tpu.training.state as jstate

    built, batches = [], []

    def config(**kw):
        built.append(kw)
        return JaxConfig(**kw)

    def shard_batch(batch, *args):
        batches.append(batch)
        if len(batches) == 2:
            raise Stop

    stub = lambda *a, **k: None  # noqa: E731
    monkeypatch.setattr(jconfig, "Config", config)
    monkeypatch.setattr(jmodels, "create_model", stub)
    monkeypatch.setattr(jmodels, "init_model", lambda *a: (None, None))
    monkeypatch.setattr(jmesh, "make_mesh", stub)
    monkeypatch.setattr(jmesh, "shard_batch", shard_batch)
    monkeypatch.setattr(joptim, "create_optimizer", lambda *a, **k: (None, None))
    for name in ("create_train_state", "jit_train_step", "make_train_step"):
        monkeypatch.setattr(jstate, name, stub)
    small = ["--batch", "2", "--height", "32", "--width", "48", "--raw_height", "40",
             "--raw_width", "56"]
    monkeypatch.setattr(sys, "argv", ["bench_train.py", *small, *flags])
    with pytest.raises(Stop):
        load_script("scripts/bench_train.py").main()

    args = bench_train.parse([*small, *flags])
    cfg = bench_train.bench_config(args)
    assert cfg == Config(**built[0])
    if "--remat" in flags:
        model = bts.create_model(cfg)
        assert (cfg.remat, cfg.remat_policy, cfg.remat_scope) == (True, "full", "all")
        assert (model.remat, model.remat_policy, model.remat_scope) == (True, "full", "all")
    ours = bench_train.host_batches(args)
    for want, got in zip(batches, ours, strict=True):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_bench_lpg_cases_draws_and_keys_are_the_scripts(monkeypatch, capsys):
    """scripts/bench_lpg.py run with its timing stubbed: its six cases' planes
    (handed to jnp), its K1, K2, REPS and B, and its rows' keys but the
    roofline's, renamed for the card's HBM rate, and the timing method."""
    script = load_script("scripts/bench_lpg.py")
    planes = []
    monkeypatch.setattr(script, "jnp", types.SimpleNamespace(asarray=lambda a: planes.append(
        a.copy()) or a))
    monkeypatch.setattr(script, "_time_scan", lambda *a: 0.0)
    script.main()
    rows = printed(capsys)
    assert (script.K1, script.K2, script.REPS) == (bench_lpg.K1, bench_lpg.K2, bench_lpg.REPS)
    assert [(r["upratio"], *map(int, r["grid"].split("x"))) for r in rows] == bench_lpg.CASES
    assert {r["batch"] for r in rows} == {bench_lpg.B}
    rng = np.random.default_rng(0)
    for (r, h, w), want in zip(bench_lpg.CASES, planes, strict=True):
        np.testing.assert_array_equal(bench_lpg.seeded_planes(rng, h, w), want)
    script_keys = set(rows[0]) - {"fwd_roofline_us_at_819GBps"}

    monkeypatch.setattr(bench_lpg, "CASES", [(4, 3, 5)])
    monkeypatch.setattr(bench_lpg, "B", 2)
    monkeypatch.setattr(bench_lpg, "K1", 2)
    monkeypatch.setattr(bench_lpg, "K2", 4)
    monkeypatch.setattr(bench_lpg, "REPS", 1)
    (row,) = bench_lpg.main(["--device", "cpu"])
    assert printed(capsys) == [row]
    assert set(row) == script_keys | {"fwd_roofline_us", "method"}
    assert row["method"] == "host"
    assert row["fwd_roofline_us"] == round(2 * 3 * 5 * (4 + 2 * 16) * 4 / 3.35e12 * 1e6, 3)


def test_zoo_is_the_scripts():
    assert bench_zoo.ZOO == load_script("scripts/bench_zoo.py").ZOO
    assert set(bench_zoo.ZOO) <= set(bts.ENCODERS)


def test_tools_print_the_scripts_keys(tiny_encoders, capsys):
    """Each tool once at a tiny size on the CPU: one JSON line per result,
    with the keys of its script's line (bench_train without vs_baseline, a
    TPU v5e's number)."""
    (line,) = bench.main([*SMALL, "--encoder", TINY])
    assert printed(capsys) == [line]
    assert set(line) in json_keys("bench.py")
    assert line["metric"] == bench.METRIC and line["unit"] == "img/s" and line["value"] > 0

    lines = bench.main([*SMALL, "--encoder", TINY, "--lpg-check"])
    assert printed(capsys) == lines
    assert [x["metric"] for x in lines] == ["lpg_check_default", "lpg_check_plain",
                                            "lpg_check_max_abs_diff_m"]
    assert all(set(x) in json_keys("bench.py") for x in lines)
    assert lines[2]["value"] < bench.LPG_CHECK_TOL_M

    (line,) = bench_train.main(["--device", "cpu", "--encoder", TINY, "--batch", "2",
                                "--steps", "2", "--delay", "1", "--height", str(H),
                                "--width", str(W), "--raw_height", "80", "--raw_width", "112"])
    assert printed(capsys) == [line]
    (script_keys,) = json_keys("scripts/bench_train.py")
    assert set(line) == script_keys - {"vs_baseline"}
    assert line["metric"] == f"train_step_{TINY}_{H}x{W}_b2" and line["device_augment"]
    assert np.isfinite(line["value"]) and line["unit"] == "examples/s"

    lines = bench_zoo.main([TINY, TINY2, *SMALL])
    assert printed(capsys) == lines
    (script_keys,) = json_keys("scripts/bench_zoo.py")
    assert [x["encoder"] for x in lines] == [TINY, TINY2]
    assert all(set(x) == script_keys and x["shape"] == f"{H}x{W}" for x in lines)


def test_pipelined_reads_back_delay_calls_late():
    """bench.py's loop: call i, then read call i - delay back; the rest at the
    end. A value read back that is not finite raises."""
    log = []

    class Result:
        def __init__(self, i):
            self.i = i

        def item(self):
            log.append(("read", self.i))
            return float("nan") if self.i == 9 else float(self.i)

    def fn(i):
        log.append(("call", i))
        return Result(i)

    assert benchtools.pipelined(fn, 4, 2) >= 0
    assert log == [("call", 0), ("call", 1), ("call", 2), ("read", 0), ("call", 3),
                   ("read", 1), ("read", 2), ("read", 3)]
    with pytest.raises(FloatingPointError, match="a timed call returned nan"):
        benchtools.pipelined(lambda i: fn(9), 1, 1)


@pytest.mark.parametrize("tool,argv", [
    (bench, []), (bench, ["--lpg-check"]), (bench_train, []), (bench_zoo, []),
    (bench_lpg, []),
])
def test_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        tool.main(argv)
