"""The port's demos and their CLIs against bts_tpu's on the CPU: the live3d
and live3d_gl numerics (copies, so bit for bit), ``run_sequence`` and
``run_headless`` end to end with a tiny model on the same weights, and every
``bts-torch-*`` script resolving to a ``main``."""

import importlib
import os
import tomllib

import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.apps import live3d as jlive3d
from bts_tpu.apps import live3d_gl as jlive3d_gl
from bts_tpu.apps import sequence as jsequence
from bts_tpu.config import Config as JConfig
from bts_tpu.models import bts as jbts
from bts_tpu.models.convert import convert_state_dict, load_torch_checkpoint
from bts_tpu_torch.apps import live3d, live3d_gl, sequence
from bts_tpu_torch.cli import live3d as cli_live3d
from bts_tpu_torch.cli import sequence as cli_sequence
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import bts

from test_torch_model import tiny_encoder  # noqa: F401  (fixture)
from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_zoo_helpers import model_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_DEPTH = 10.0
# Forward outputs at rtol 1e-3, atol 1e-4 of the unit map (the model
# tests' tolerances), so 1e-4 * max_depth in meters.
OUT_TOL = dict(rtol=1e-3, atol=1e-4 * MAX_DEPTH)


# ------------------------------------------------------------ numerics


def test_live3d_numerics_match_bts_tpu():
    rng = np.random.default_rng(0)
    cam = np.array([[600.0, 0, 330.0], [0, 605.0, 235.0], [0, 0, 1]])
    new_cam = np.array([[518.8579, 0, 320.0], [0, 518.8579, 240.0], [0, 0, 1]])
    dist = np.array([0.1, -0.05, 1e-3, -2e-3, 0.01])
    for got, want in zip(live3d.undistort_maps(cam, dist, new_cam, (64, 48)),
                         jlive3d.undistort_maps(cam, dist, new_cam, (64, 48)), strict=True):
        np.testing.assert_array_equal(got, want)
    map_x, map_y = live3d.undistort_maps(cam, dist, new_cam, (64, 48))
    image = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(live3d.remap_nearest(image, map_x, map_y),
                                  jlive3d.remap_nearest(image, map_x, map_y))
    depth = rng.uniform(0.5, 5.0, (48, 64)).astype(np.float32)
    depth[10:20, 30:40] += 2.0  # a step: the edge mask drops its rim
    rays = live3d.pixel_rays(48, 64)
    np.testing.assert_array_equal(rays, jlive3d.pixel_rays(48, 64))
    np.testing.assert_array_equal(live3d.unproject(depth, rays), jlive3d.unproject(depth, rays))
    keep = live3d.sobel_edge_mask(depth)
    np.testing.assert_array_equal(keep, jlive3d.sobel_edge_mask(depth))
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(live3d.center_crop(image, 32, 40),
                                  jlive3d.center_crop(image, 32, 40))

    def depth_fn(rgb):
        return depth[:32, :64]

    points, colors = live3d.frame_to_cloud(image, depth_fn)
    jpoints, jcolors = jlive3d.frame_to_cloud(image, depth_fn)
    np.testing.assert_array_equal(points, jpoints)
    np.testing.assert_array_equal(colors, jcolors)
    for view in ((0.0, 0.0), (-25.0, -10.0)):
        np.testing.assert_array_equal(
            live3d.render_cloud(points, colors, 48, 64, *view),
            jlive3d.render_cloud(points, colors, 48, 64, *view))


def test_live3d_gl_numerics_match_bts_tpu():
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(live3d_gl.perspective(45.0, 4 / 3, 0.01, 100.0),
                                  jlive3d_gl.perspective(45.0, 4 / 3, 0.01, 100.0))
    view = ((0.1, -0.2, -0.4), (0.0, -0.075, 0.0), (0.0, -1.0, 0.0))
    np.testing.assert_array_equal(live3d_gl.look_at(*view), jlive3d_gl.look_at(*view))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(live3d_gl.rotate(m, 0.7, (1, 2, 3)),
                                  jlive3d_gl.rotate(m, 0.7, (1, 2, 3)))
    got, want = live3d_gl.Trackball(), jlive3d_gl.Trackball()
    for ball in (got, want):
        ball.drag(12, -5, "left")
        ball.drag(-3, 8, "right")
        ball.wheel(240)
    assert vars(got) == vars(want)
    np.testing.assert_array_equal(got.mvp(640, 480), want.mvp(640, 480))
    depth = rng.uniform(0.5, 5.0, (24, 32)).astype(np.float32)
    rgb = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    for g, w in zip(live3d_gl.cloud_vertex_data(depth, rgb),
                    jlive3d_gl.cloud_vertex_data(depth, rgb), strict=True):
        np.testing.assert_array_equal(g, w)
    assert live3d_gl.VERTEX_SHADER_SRC == jlive3d_gl.VERTEX_SHADER_SRC
    assert live3d_gl.FRAGMENT_SHADER_SRC == jlive3d_gl.FRAGMENT_SHADER_SRC


def test_live3d_gl_gui_is_gated_on_its_imports():
    """Without Qt and PyOpenGL, building the widget raises ImportError, as
    bts_tpu's does; the numerics above need neither."""
    try:
        jlive3d_gl._import_gui()
    except ImportError:
        with pytest.raises(ImportError):
            live3d_gl.make_widget_class()
    else:
        assert live3d_gl.make_widget_class().__name__ == "GLPointCloudWidget"


# ------------------------------------------------------------ end to end


@pytest.fixture
def tiny_checkpoint(tiny_encoder, tmp_path):
    """Seeded tiny-model weights, BN statistics away from init, written by
    the port; both packages load them through ``--checkpoint_path``."""
    args = dict(encoder=tiny_encoder, dataset="nyu", max_depth=MAX_DEPTH, bts_size=128,
                lpg_impl="pallas", checkpoint_path=str(tmp_path / "tiny.pth"))
    model = bts.create_model(Config(**args))
    gen = torch.Generator().manual_seed(7)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save({"model": model.state_dict()}, args["checkpoint_path"])
    return args


def jax_model(args):
    """bts_tpu's model and variables with the checkpoint's weights (its
    templates from eval_shape: a jitted init costs seconds on the CPU)."""
    jmodel = jbts.create_model(JConfig(**args, fast_tail=False))
    params, stats = model_variables(jmodel, np.random.default_rng(0))
    params, stats = convert_state_dict(load_torch_checkpoint(args["checkpoint_path"]), params,
                                       stats, strict=True)
    return jmodel, {"params": params, "batch_stats": stats}


def write_frames(directory, n, h, w, seed):
    directory.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            directory / f"frame_{i:03d}.png")
    return directory


def record(monkeypatch, module, name, store):
    """Wrap ``module.name`` so each call's first argument goes to ``store``."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        store.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def test_sequence_matches_bts_tpu(tiny_checkpoint, tmp_path, monkeypatch):
    """3 frames of 60x90 (edge-padded to 64x96 and cropped back): the same
    png names, and the depth and LPG maps that go into the colormap within
    OUT_TOL of bts_tpu's."""
    frames = write_frames(tmp_path / "frames", 3, 60, 90, seed=3)
    want, got = [], []
    record(monkeypatch, jsequence, "colorize", want)
    record(monkeypatch, sequence, "colorize", got)
    jmodel, variables = jax_model(tiny_checkpoint)
    assert jsequence.run_sequence(JConfig(**tiny_checkpoint, fast_tail=False), str(frames),
                                  str(tmp_path / "jax"), jmodel, variables) == 3
    argv = [f"--{k}={v}" for k, v in tiny_checkpoint.items()]
    assert cli_sequence.main(argv + ["--image_dir", str(frames), "--out_dir",
                                     str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 12
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.shape == w.shape == (60, 90)
        np.testing.assert_allclose(g, w, **OUT_TOL)


def test_live3d_headless_matches_bts_tpu(tiny_checkpoint, tmp_path, monkeypatch):
    """2 frames of 70x100 (center-cropped to 64x96): the depth within
    OUT_TOL of bts_tpu's, and the same renders' names and sizes."""
    frames = write_frames(tmp_path / "frames", 2, 70, 100, seed=4)
    want, got = [], []
    jmodel, variables = jax_model(tiny_checkpoint)
    for module, store, kw in ((jlive3d, want, dict(model=jmodel, variables=variables)),
                              (live3d, got, {})):
        real = module.make_depth_fn

        def make(*a, _real=real, _store=store, _kw=kw):
            fn = _real(*a, **_kw)
            return lambda rgb: _store.append(fn(rgb)) or _store[-1]

        monkeypatch.setattr(module, "make_depth_fn", make)
    assert jlive3d.run_headless(JConfig(**tiny_checkpoint, fast_tail=False), str(frames),
                                str(tmp_path / "jax")) == 2
    argv = [f"--{k}={v}" for k, v in tiny_checkpoint.items()]
    assert cli_live3d.main(argv + ["--image_dir", str(frames), "--out_dir",
                                   str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 96)
        np.testing.assert_allclose(g, np.asarray(w), **OUT_TOL)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        assert np.asarray(Image.open(tmp_path / "port" / name)).shape == (70, 100, 3)


def test_sequence_focal_and_missing_image_dir():
    cfg = Config()
    assert sequence.sequence_focal(cfg) == 518.8579
    assert sequence.sequence_focal(cfg.replace(dataset="kitti")) == 718.856
    assert sequence.sequence_focal(cfg.replace(focal=300.0)) == 300.0
    assert cli_sequence.main(["--device", "cpu"]) == 1


# ------------------------------------------------------------ scripts


def test_every_torch_script_resolves_to_main():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    torch_scripts = {k: v for k, v in scripts.items() if k.startswith("bts-torch-")}
    # One bts-torch-* script for each bts-* script of bts_tpu.
    assert {k.replace("bts-torch-", "bts-") for k in torch_scripts} == {
        k for k in scripts if not k.startswith("bts-torch-")}
    for name, target in torch_scripts.items():
        module, func = target.split(":")
        assert module.startswith("bts_tpu_torch.cli.") and func == "main", name
        assert callable(getattr(importlib.import_module(module), func)), name
