"""The serving path: ``python -m bts_tpu_torch.cli.test`` on the CPU against
bts_tpu's run_predictions on the same frames with the same weights."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.apps.predict import run_predictions as jax_run_predictions
from bts_tpu.config import Config
from bts_tpu_torch.cli import test as cli_test
from bts_tpu_torch.models import bts

from test_torch_model import tiny_encoder  # noqa: F401  (fixture)
from torch_threads import one_thread  # noqa: F401 (fixture)

H, W = 60, 90  # not multiples of 32: both sides pad to 64x96 and crop back
INPUT_H, INPUT_W = 64, 96  # bts_tpu initializes its model at this size


@pytest.fixture
def nyu_frames(tmp_path):
    """Five synthetic NYU frames and their manifest."""
    scene = tmp_path / "data" / "kitchen_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(5)
    lines = []
    for i in range(5):
        rgb = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
        depth = rng.integers(500, 9000, size=(H, W), dtype=np.uint16)
        Image.fromarray(rgb).save(scene / f"rgb_{i:05d}.jpg")
        Image.fromarray(depth).save(scene / f"sync_depth_{i:05d}.png")
        lines.append(
            f"kitchen_0001/rgb_{i:05d}.jpg kitchen_0001/sync_depth_{i:05d}.png 518.8579"
        )
    manifest = tmp_path / "data" / "files.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return tmp_path / "data", manifest


def test_cli_matches_bts_tpu_predictions(tiny_encoder, nyu_frames, tmp_path, monkeypatch):
    root, manifest = nyu_frames
    args = {
        "encoder": tiny_encoder, "dataset": "nyu", "max_depth": 10.0,
        "data_path": str(root), "filenames_file": str(manifest),
        "input_height": INPUT_H, "input_width": INPUT_W, "eval_batch_size": 2,
        "bts_size": 128, "lpg_impl": "pallas", "model_name": "tiny",
        "checkpoint_path": str(tmp_path / "tiny.pth"),
    }
    # Seeded weights with BN stats away from init, written by the port.
    model = bts.create_model(Config(**args))
    gen = torch.Generator().manual_seed(7)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save({"model": model.state_dict()}, args["checkpoint_path"])

    want_dir = jax_run_predictions(
        Config(**args, fast_tail=False), out_dir=str(tmp_path / "jax")
    )
    monkeypatch.chdir(tmp_path)
    argv = [f"--{k}={v}" for k, v in args.items()] + ["--device", "cpu", "--save_lpg"]
    assert cli_test.main(argv) == 0
    got_dir = tmp_path / "result_tiny"

    names = sorted(os.listdir(got_dir / "raw"))
    assert names == sorted(os.listdir(os.path.join(want_dir, "raw")))
    assert len(names) == 5 and names[0] == "kitchen_0001_rgb_00000.png"
    for name in names:
        got = np.asarray(Image.open(got_dir / "raw" / name))
        want = np.asarray(Image.open(os.path.join(want_dir, "raw", name)))
        assert got.dtype == want.dtype == np.uint16 and got.shape == (H, W)
        # x1000 then truncation to uint16 can flip one count at f32 rounding.
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert sorted(os.listdir(got_dir / "rgb")) == sorted(os.listdir(got_dir / "gt")) == names
    assert len(os.listdir(got_dir / "cmap")) == 5 * len(names)


def test_cli_without_card_needs_device_cpu(tiny_encoder, nyu_frames, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    root, manifest = nyu_frames
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_test.main([f"--encoder={tiny_encoder}", f"--data_path={root}",
                       f"--filenames_file={manifest}"])
