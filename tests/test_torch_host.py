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


# ------------------------------------------------------------ eval copies


def _protocol_inputs(seed, h, w, max_d):
    """A seeded prediction with inf, nan and out-of-range values, and gt in
    meters with zero holes."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-1, max_d * 1.3, (h, w)).astype(np.float32)
    pred.reshape(-1)[rng.integers(0, h * w, 30)] = np.inf
    pred.reshape(-1)[rng.integers(0, h * w, 30)] = np.nan
    gt = rng.uniform(0, max_d, (h, w)).astype(np.float32)
    gt[rng.random((h, w)) < 0.2] = 0
    return pred, gt


@pytest.mark.parametrize("dataset,h,w,crops", [
    ("nyu", 480, 640, dict(eigen_crop=True)),
    ("nyu", 48, 64, {}),
    ("kitti", 375, 1242, dict(garg_crop=True, do_kb_crop=True)),
    ("kitti", 352, 1216, dict(eigen_crop=True)),
])
def test_eval_protocol_matches(dataset, h, w, crops):
    """clamp_prediction, kb_crop_reembed, eval_mask and prepare_pred_gt (a
    352x1216 prediction re-embedded into a larger KITTI gt), and
    compute_errors on the result, bit for bit."""
    from bts_tpu.evaluation import metrics as jmetrics
    from bts_tpu.evaluation import protocol as jprotocol
    from bts_tpu_torch.evaluation import metrics, protocol

    max_d = 10.0 if dataset == "nyu" else 80.0
    pred, gt = _protocol_inputs(h + w, h, w, max_d)
    if crops.get("do_kb_crop"):
        pred = pred[:352, :1216]
        np.testing.assert_array_equal(protocol.kb_crop_reembed(pred, h, w),
                                      jprotocol.kb_crop_reembed(pred, h, w))
    np.testing.assert_array_equal(protocol.clamp_prediction(pred, 1e-3, max_d),
                                  jprotocol.clamp_prediction(pred, 1e-3, max_d))
    mask_kw = {k: v for k, v in crops.items() if k != "do_kb_crop"}
    np.testing.assert_array_equal(protocol.eval_mask(gt, 1e-3, max_d, dataset, **mask_kw),
                                  jprotocol.eval_mask(gt, 1e-3, max_d, dataset, **mask_kw))
    got = protocol.prepare_pred_gt(pred, gt, 1e-3, max_d, dataset, **crops)
    want = jprotocol.prepare_pred_gt(pred, gt, 1e-3, max_d, dataset, **crops)
    for g, wv in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, wv)
    p, g, m = got
    np.testing.assert_array_equal(metrics.compute_errors(g[m], p[m]),
                                  jmetrics.compute_errors(g[m], p[m]))
    assert metrics.EVAL_METRICS == jmetrics.EVAL_METRICS
    assert (metrics.NUM_LOWER_BETTER, metrics.NUM_HIGHER_BETTER) == (
        jmetrics.NUM_LOWER_BETTER, jmetrics.NUM_HIGHER_BETTER)


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_pack_gt_batch_matches(dataset):
    """A batch with a missing gt, a weight-0 sample and a mismatched shape."""
    from bts_tpu.evaluation import device_eval as jdevice
    from bts_tpu_torch.evaluation import device_eval

    scale = 1000.0 if dataset == "nyu" else 256.0
    rng = np.random.default_rng(9)
    depths = [(rng.integers(0, 20000, (12, 16, 1)) / scale).astype(np.float32) for _ in range(3)]
    depths += [None, (rng.integers(0, 20000, (10, 16, 1)) / scale).astype(np.float32)]
    weights = [1.0, 0.0, 1.0, 1.0, 1.0]
    for pred_shape in (None, (12, 16)):
        with pytest.warns(UserWarning, match="cannot ride the batched"):
            got = device_eval.pack_gt_batch(depths, weights, dataset, pred_shape)
        with pytest.warns(UserWarning, match="cannot ride the batched"):
            want = jdevice.pack_gt_batch(depths, weights, dataset, pred_shape)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
        assert got[0].dtype == want[0].dtype == np.uint16 and got[2] == [4]


@pytest.mark.parametrize("dataset,name", [
    ("nyu", "/p/kitchen_0001_rgb_00003.png"),
    ("nyu", "/p/bathroom_0042_rgb_00017.jpg"),
    ("nyu", "/p/depth_00003.png"),
    ("kitti", "/p/2011_09_26_drive_0002_sync_0000000005.png"),
    ("kitti", "/p/x.png"),
])
def test_gt_path_for_pred_matches(dataset, name):
    from bts_tpu.evaluation import png_eval as jpng
    from bts_tpu_torch.evaluation import png_eval

    kw = dict(dataset=dataset, gt_path="/gt")
    assert png_eval.gt_path_for_pred(name, config.Config(**kw)) == jpng.gt_path_for_pred(
        name, jconfig.Config(**kw))


# ------------------------------------------- data tools, cli.test, reproduction

from bts_tpu.data.tools import download as jdownload  # noqa: E402
from bts_tpu.data.tools import extract_nyu as jextract_nyu  # noqa: E402
from bts_tpu.data.tools import make_manifests as jmake_manifests  # noqa: E402
from bts_tpu_torch.data.tools import download, extract_nyu, make_manifests  # noqa: E402

from test_data_tools import _write_pgm16, nyu_mat  # noqa: E402,F401 (fixture)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_extract_nyu_and_nyu_manifest_match(nyu_mat, tmp_path):
    """The copy writes bts_tpu's files byte for byte from
    tests/test_data_tools.py's synthetic .mat, and the NYU manifest of the
    tree and make_manifests' entry point print alike."""
    labeled, splits, _, _ = nyu_mat
    outs = [str(tmp_path / name) for name in ("port", "bts_tpu")]
    assert extract_nyu.extract(labeled, splits, outs[0]) == jextract_nyu.extract(
        labeled, splits, outs[1]) == 2
    assert _tree(outs[0]) == _tree(outs[1]) and len(_tree(outs[0])) == 4
    for split in ("train", "test"):
        assert (make_manifests.nyu_manifest(outs[0], split)
                == jmake_manifests.nyu_manifest(outs[0], split))
    assert extract_nyu.main([]) == jextract_nyu.main([]) == 1


def test_sync_nyu_raw_matches(tmp_path, capsys):
    """NYU raw frame pairing on tests/test_data_tools.py's synthetic scene
    (r-*.ppm, d-*.pgm): the same synced files, byte for byte."""
    scene = tmp_path / "basement_0001a"
    scene.mkdir()
    rng = np.random.default_rng(1)
    for i in range(15):
        t = 1300000000.0 + i * 0.1
        Image.fromarray(rng.integers(0, 255, size=(12, 16, 3), dtype=np.uint8)).save(
            scene / f"r-{t:.6f}-{i}.ppm")
        _write_pgm16(scene / f"d-{t + 0.02:.6f}-{i}.pgm",
                     np.full((12, 16), int(1092.5 - 351.3 / 2.0), dtype=np.uint16))
    outs = [str(tmp_path / name) for name in ("port", "bts_tpu")]
    assert make_manifests.main(["sync", str(scene), outs[0]]) == 0
    assert jmake_manifests.main(["sync", str(scene), outs[1]]) == 0
    assert _tree(outs[0]) == _tree(outs[1]) and len(_tree(outs[0])) == 6
    out = capsys.readouterr().out
    assert out.count("Synced 3 frames") == 2


def test_kitti_manifest_and_download_lists_match(tmp_path, capsys):
    """The KITTI manifest of a miniature raw + gt tree (with right-camera
    columns), the archive lists of the repo's eigen splits and the NYU list,
    the aria2c list file and the entry points' output, against bts_tpu's
    (no fetch)."""
    raw, gt = tmp_path / "raw", tmp_path / "gt"
    date, drive = "2011_09_26", "2011_09_26_drive_0002_sync"
    for cam in ("image_02", "image_03"):
        d = raw / date / drive / cam / "data"
        d.mkdir(parents=True)
        Image.new("RGB", (8, 4)).save(d / "0000000005.png")
        g = gt / "train" / drive / "proj_depth" / "groundtruth" / cam
        g.mkdir(parents=True)
        Image.fromarray(np.zeros((4, 8), np.uint16)).save(g / "0000000005.png")
    (raw / date / "calib_cam_to_cam.txt").write_text(
        "P_rect_01: 1.0 0 0 0\nP_rect_02: 721.5377 0.0 609.5593 44.857\n"
        "P_rect_03: 721.5377 0.0 609.5593 -339.5\n")
    for use_right in (False, True):
        got = make_manifests.kitti_manifest(str(raw), str(gt), use_right=use_right)
        assert got == jmake_manifests.kitti_manifest(str(raw), str(gt), use_right=use_right)
        assert len(got) == 1
    split = os.path.join(ROOT, "train_test_inputs", "eigen_test_files_with_gt.txt")
    urls = download.kitti_archives_for_manifest(split)
    assert urls == jdownload.kitti_archives_for_manifest(split) and urls
    assert download.nyu_archive_urls() == jdownload.nyu_archive_urls()
    download.write_aria2_list(urls, str(tmp_path / "port.txt"))
    jdownload.write_aria2_list(urls, str(tmp_path / "bts_tpu.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "bts_tpu.txt").read_bytes()
    capsys.readouterr()
    for port_main, bts_tpu_main, argv in [
            (download.main, jdownload.main, ["--kitti-list", split]),
            (download.main, jdownload.main, ["--nyu-list"]),
            (download.main, jdownload.main, []),
            (make_manifests.main, jmake_manifests.main, ["kitti", str(raw), str(gt)]),
            (make_manifests.main, jmake_manifests.main, ["nyu"])]:
        rc = port_main(argv)
        port_out = capsys.readouterr().out
        assert (rc, port_out) == (bts_tpu_main(argv), capsys.readouterr().out), argv


def _nyu_frames(root, n, h, w):
    scene = root / "kitchen_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(4)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            scene / f"rgb_{i:05d}.jpg")
        Image.fromarray(rng.integers(500, 9000, (h, w), dtype=np.uint16)).save(
            scene / f"sync_depth_{i:05d}.png")
        lines.append(f"kitchen_0001/rgb_{i:05d}.jpg kitchen_0001/sync_depth_{i:05d}.png "
                     "518.8579")
    manifest = root / "files.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


def test_cli_test_runs_the_run_dirs_snapshot(tmp_path):
    """A checkpoint inside a run dir that holds a code snapshot is served with
    the snapshot's code: ``python -m bts_tpu_torch.cli.test`` re-executes
    from it (a marker planted in the snapshot's apps/predict.py prints)."""
    import subprocess
    import sys

    import torch

    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.training.snapshot import snapshot_run

    root = tmp_path / "data"
    manifest = _nyu_frames(root, 2, 64, 96)
    kw = dict(encoder="densenet121_bts", bts_size=128, dataset="nyu", data_path=str(root),
              filenames_file=str(manifest), input_height=64, input_width=96,
              log_directory=str(tmp_path / "logs"), model_name="snap")
    run_dir = snapshot_run(config.Config(**kw))
    with open(os.path.join(run_dir, "bts_tpu_torch", "apps", "predict.py"), "a") as f:
        f.write('\nprint("predict from the snapshot")\n')
    ckpt = os.path.join(run_dir, "model-4")
    torch.save({"model": create_model(config.Config(**kw)).state_dict()}, ckpt)
    argv = [f"--{k}={v}" for k, v in kw.items() if k != "log_directory"]
    out = subprocess.run([sys.executable, "-m", "bts_tpu_torch.cli.test", "--device", "cpu",
                          f"--checkpoint_path={ckpt}", *argv], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"Using model snapshot from {run_dir}" in out.stdout
    assert "predict from the snapshot" in out.stdout
    assert len(os.listdir(tmp_path / "result_snap" / "raw")) == 2


def _script_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("encoder,dataset,flavor", [
    ("densenet161_bts", "nyu", "pt"), ("densenet161_bts", "kitti", "tf"),
    ("resnext101_bts", "kitti", "pt"), ("mobilenetv2_bts", "nyu", "pt")])
def test_reproduce_reference_check_metrics_matches(encoder, dataset, flavor):
    """The port's reproduction keeps scripts/reproduce_reference.py's
    published table, protocol and verdicts."""
    from bts_tpu_torch.tools import reproduce_reference as port

    script = _script_module("reproduce_reference")
    assert (port.PUBLISHED, port.PROTOCOL, port.METRIC_INDEX) == (
        script.PUBLISHED, script.PROTOCOL, script.METRIC_INDEX)
    for measures in (np.linspace(0.05, 0.96, 9), np.full(9, 0.11), np.zeros(9)):
        for tol in (0.002, 0.5):
            assert port.check_metrics(measures, encoder, dataset, flavor, tol) == \
                script.check_metrics(measures, encoder, dataset, flavor, tol)


def test_reproduce_reference_end_to_end_on_synthetic_frames(tmp_path, monkeypatch, capsys):
    """Predict and score 2 synthetic NYU 480x640 frames with a seeded
    DenseNet121-BTS .pth on the CPU: the flavor and normalization resolved,
    2 samples scored, and a miss against the published row (exit 1); an
    orbax directory is refused with the export script named."""
    import torch

    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.tools import reproduce_reference

    root = tmp_path / "data"
    manifest = _nyu_frames(root, 2, 480, 640)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"model": create_model(config.Config(encoder="densenet121_bts",
                                                    bts_size=128)).state_dict()}, ckpt)
    monkeypatch.chdir(tmp_path)
    argv = ["--encoder", "densenet121_bts", "--dataset", "nyu", "--data_path", str(root),
            "--gt_path", str(root), "--filenames_file", str(manifest), "--bts_size", "128",
            "--eval_batch_size", "2", "--device", "cpu"]
    assert reproduce_reference.main([*argv, "--checkpoint", ckpt]) == 1
    out = capsys.readouterr().out
    assert "resolved flavor: pt; normalization: imagenet" in out
    assert "2 samples scored" in out and "MISS" in out and out.rstrip().endswith("FAIL")
    assert not (tmp_path / "result_reproduce").exists()
    with pytest.raises(NotImplementedError, match="export_orbax_to_pth"):
        reproduce_reference.main([*argv, "--checkpoint", str(tmp_path)])
