"""The port's copies of bts_tpu's host modules against the originals, on the
CPU: the Config, its parser and its args-file writer, the eval and train
data paths (manifest, transforms, EvalLoader, TrainLoader), colorize and the
prediction dump's naming and png writing."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from bts_tpu import config as jconfig
from bts_tpu.apps import predict as jpredict
from bts_tpu.data import loader as jloader
from bts_tpu.data import transforms as jtransforms
from bts_tpu.utils import colorize as jcolorize
from bts_tpu_torch import config
from bts_tpu_torch.apps import predict
from bts_tpu_torch.data import loader, transforms
from bts_tpu_torch.utils import colorize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = ("model_flavor", "normalization")  # the port resolves both in parse_args


def test_config_fields_and_defaults_match():
    want = [(f.name, f.type) for f in dataclasses.fields(jconfig.Config)]
    assert [(f.name, f.type) for f in dataclasses.fields(config.Config)] == want
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(jconfig.Config())
    jflags = {a.dest: (a.option_strings, a.default) for a in jconfig._build_parser()._actions}
    assert {a.dest: (a.option_strings, a.default)
            for a in config._build_parser()._actions} == jflags


@pytest.mark.parametrize("name", ["arguments_test_nyu.txt", "arguments_test_eigen.txt",
                                  "arguments_train_nyu.txt", "arguments_train_eigen.txt"])
def test_args_file_parses_alike(name):
    path = os.path.join(ROOT, "configs", name)
    got = dataclasses.asdict(config.parse_args([path]))
    want = dataclasses.asdict(jconfig.parse_args([path]))
    for field in PINNED:
        got.pop(field), want.pop(field)
    assert got == want
    assert got["encoder"] == "densenet161_bts"


@pytest.mark.parametrize("argv", [
    ["--no-fast_tail", "--gpu", "3", "--normalization", "caffe"],
    ["--encoder", "densenet121_bts", "--normalization", "caffe_unscaled", "--save_lpg"],
])
def test_flags_parse_alike(argv):
    got = config.parse_args(argv)
    want = jconfig.parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want.replace(model_flavor="pt"))
    assert want.resolved_flavor == "pt"
    assert got.resolved_normalization == want.resolved_normalization
    assert got.depth_mask_min == want.depth_mask_min


def _write_frames(root, dataset, shapes):
    """Synthetic frames (uint8 rgb jpg + uint16 depth png) and a manifest;
    one frame without gt."""
    rng = np.random.default_rng(11)
    lines = []
    for i, (h, w) in enumerate(shapes):
        if dataset == "nyu":
            img, gt = f"kitchen_0001/rgb_{i:05d}.jpg", f"kitchen_0001/sync_depth_{i:05d}.png"
        else:
            img = f"2011_09_26/2011_09_26_drive_0002_sync/image_02/data/{i:010d}.png"
            gt = f"2011_09_26_drive_0002_sync/proj_depth/groundtruth/image_02/{i:010d}.png"
        for rel, arr in ((img, rng.integers(0, 255, (h, w, 3), dtype=np.uint8)),
                         (gt, rng.integers(0, 20000, (h, w), dtype=np.uint16))):
            os.makedirs(os.path.dirname(root / rel), exist_ok=True)
            Image.fromarray(arr).save(root / rel)
        lines.append(f"{img} {'None' if i == 2 else gt} {518.8579 + i}")
    manifest = root / "files.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


@pytest.mark.parametrize("dataset,mode,do_kb_crop,shapes", [
    ("nyu", "test", False, [(48, 64)] * 5),
    ("nyu", "online_eval", False, [(48, 64), (40, 56), (48, 64), (48, 64), (40, 56)]),
    ("kitti", "online_eval", True, [(360, 1230)] * 3),
    ("kitti", "test", False, [(36, 120)] * 3),
])
def test_eval_loader_matches(tmp_path, dataset, mode, do_kb_crop, shapes):
    manifest = _write_frames(tmp_path, dataset, shapes)
    kw = dict(dataset=dataset, data_path=str(tmp_path), gt_path=str(tmp_path),
              filenames_file=str(manifest), do_kb_crop=do_kb_crop, eval_batch_size=2,
              normalization="imagenet")
    got = list(loader.EvalLoader(config.Config(**kw), mode).batches())
    want = list(jloader.EvalLoader(jconfig.Config(**kw), mode).batches())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("image", "focal", "weight"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
        assert [dataclasses.astuple(e) for e in g["entries"]] == [
            dataclasses.astuple(e) for e in w["entries"]]
        assert len(g["depths"]) == len(w["depths"])
        for gd, wd in zip(g["depths"], w["depths"]):
            assert (gd is None) == (wd is None)
            if gd is not None:
                np.testing.assert_array_equal(gd, wd)
    if do_kb_crop:
        assert got[0]["image"].shape[1:] == (352, 1216, 3)
    if mode == "online_eval":
        assert any(d is not None for b in got for d in b["depths"])


@pytest.mark.parametrize("style", ["imagenet", "caffe", "caffe_unscaled"])
def test_normalization_matches(style):
    image = np.random.default_rng(3).random((6, 7, 3), dtype=np.float32)
    normed = transforms.normalize_image(image, style)
    np.testing.assert_array_equal(normed, jtransforms.normalize_image(image, style))
    np.testing.assert_array_equal(transforms.denormalize_image(normed, style),
                                  jtransforms.denormalize_image(normed, style))


@pytest.mark.parametrize("cmap", ["Greys", "magma"])
def test_colorize_matches(cmap):
    value = np.random.default_rng(4).uniform(0.1, 10.0, (9, 13)).astype(np.float32)
    got = colorize.colorize(value, cmap=cmap)
    assert got.dtype == np.uint8 and got.shape == (3, 9, 13)
    np.testing.assert_array_equal(got, jcolorize.colorize(value, cmap=cmap))
    np.testing.assert_array_equal(colorize.normalize_result(value),
                                  jcolorize.normalize_result(value))


@pytest.mark.parametrize("dataset,path", [
    ("nyu", "kitchen_0001/rgb_00042.jpg"),
    ("nyu", "rgb_00042.jpg"),
    ("kitti", "2011_09_26/2011_09_26_drive_0002_sync/image_02/data/0000000069.png"),
    ("kitti", "0000000069.png"),
])
def test_output_name_and_png_match(tmp_path, dataset, path):
    assert predict.output_name(path, dataset) == jpredict.output_name(path, dataset)
    depth = np.random.default_rng(6).uniform(0.0, 80.0, (12, 20)).astype(np.float32)
    predict.save_depth_png(str(tmp_path / "got.png"), depth, dataset)
    jpredict.save_depth_png(str(tmp_path / "want.png"), depth, dataset)
    assert (tmp_path / "got.png").read_bytes() == (tmp_path / "want.png").read_bytes()


def _train_frames(root, n=6, h=480, w=640):
    """NYU-style frames at the real size (the border crop needs it)."""
    rng = np.random.default_rng(12)
    lines = []
    for i in range(n):
        img, gt = f"s1/rgb_{i:05d}.jpg", f"s1/sync_depth_{i:05d}.png"
        for rel, arr in ((img, rng.integers(0, 255, (h, w, 3), dtype=np.uint8)),
                         (gt, rng.integers(500, 9000, (h, w), dtype=np.uint16))):
            os.makedirs(os.path.dirname(root / rel), exist_ok=True)
            Image.fromarray(arr).save(root / rel)
        lines.append(f"{img} {gt} 518.8579")
    manifest = root / "train.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


@pytest.mark.parametrize("device_augment", [False, True], ids=["host", "raw"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_train_loader_matches(tmp_path, device_augment, num_shards):
    manifest = _train_frames(tmp_path)
    kw = dict(dataset="nyu", data_path=str(tmp_path), gt_path=str(tmp_path),
              filenames_file=str(manifest), batch_size=2, input_height=96, input_width=128,
              device_augment=device_augment, do_random_rotate=True, normalization="imagenet",
              seed=5)
    for shard in range(num_shards):
        got = loader.TrainLoader(config.Config(**kw), num_shards, shard)
        want = jloader.TrainLoader(jconfig.Config(**kw), num_shards, shard)
        # 6 frames, a global batch of 2: 3 batches of 2, or 3 of 1 a shard.
        assert got.steps_per_epoch() == want.steps_per_epoch() == 3
        for epoch in (0, 1):
            gb, wb = list(got.epoch(epoch)), list(want.epoch(epoch))
            assert len(gb) == len(wb) == got.steps_per_epoch() > 0
            for g, w in zip(gb, wb):
                assert g.keys() == w.keys() == {"image", "depth", "focal"}
                for k in g:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k])
            shape = (427, 565) if device_augment else (96, 128)
            assert gb[0]["image"].shape[1:3] == shape


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_host_train_transforms_match(tmp_path, dataset):
    """rotate_pair, random_crop, augment_image, train_preprocess and the two
    sample loaders give the same arrays from the same Generator."""
    _train_frames(tmp_path, n=1)
    img_path = str(tmp_path / "s1" / "rgb_00000.jpg")
    gt_path = str(tmp_path / "s1" / "sync_depth_00000.png")
    pil_i, pil_d = Image.open(img_path), Image.open(gt_path)
    for a, b in zip(transforms.rotate_pair(pil_i, pil_d, 1.7),
                    jtransforms.rotate_pair(pil_i, pil_d, 1.7)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    image = np.random.default_rng(1).random((40, 50, 3), dtype=np.float32)
    depth = np.random.default_rng(2).random((40, 50, 1), dtype=np.float32)
    for seed in range(4):
        for fn, args in ((transforms.random_crop, (image, depth, 30, 20)),
                         (transforms.augment_image, (image, dataset)),
                         (transforms.train_preprocess, (image, depth, dataset))):
            jfn = getattr(jtransforms, fn.__name__)
            got = fn(*args, np.random.default_rng(seed))
            want = jfn(*args, np.random.default_rng(seed))
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, w)
    for rotate in (False, True):
        got = transforms.load_raw_train_sample(img_path, gt_path, dataset,
                                               np.random.default_rng(3), do_random_rotate=rotate)
        want = jtransforms.load_raw_train_sample(img_path, gt_path, dataset,
                                                 np.random.default_rng(3), do_random_rotate=rotate)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        got = transforms.load_train_sample(img_path, gt_path, dataset, 64, 96,
                                           np.random.default_rng(4), do_random_rotate=rotate,
                                           normalization="caffe")
        want = jtransforms.load_train_sample(img_path, gt_path, dataset, 64, 96,
                                             np.random.default_rng(4), do_random_rotate=rotate,
                                             normalization="caffe")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_config_to_argfile_matches():
    cfg = config.parse_args(["--encoder", "densenet121_bts", "--no-fast_tail", "--retrain",
                             "--learning_rate", "3e-4"])
    want = jconfig.config_to_argfile(jconfig.Config(**dataclasses.asdict(cfg)))
    assert config.config_to_argfile(cfg) == want
    assert config.parse_args(config.config_to_argfile(cfg).split()) == cfg
