"""bts_tpu_torch never loads jax, flax or anything of bts_tpu: every slice
module, and parsing the NYU test args file (whose --checkpoint_path would
make bts_tpu's Config.validate sniff it through jax-backed modules).

In a subprocess, because tests/conftest.py imports jax in this one.
"""

import json
import os
import subprocess
import sys

import pytest

from bts_tpu_torch.config import parse_args, parse_args_with_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "bts_tpu_torch",
    "bts_tpu_torch.config",
    "bts_tpu_torch.ops",
    "bts_tpu_torch.ops.lpg",
    "bts_tpu_torch.ops.lpg_cuda",
    "bts_tpu_torch.ops.fused_dense",
    "bts_tpu_torch.ops.fused_dense_cuda",
    "bts_tpu_torch.ops._build",
    "bts_tpu_torch.data",
    "bts_tpu_torch.data.manifest",
    "bts_tpu_torch.data.transforms",
    "bts_tpu_torch.data.loader",
    "bts_tpu_torch.utils",
    "bts_tpu_torch.utils.colorize",
    "bts_tpu_torch.models",
    "bts_tpu_torch.models.layers",
    "bts_tpu_torch.models.encoders.densenet",
    "bts_tpu_torch.models.decoder",
    "bts_tpu_torch.models.bts",
    "bts_tpu_torch.models.convert",
    "bts_tpu_torch.apps.predict",
    "bts_tpu_torch.cli.test",
    "bts_tpu_torch.tools.profile_forward",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from bts_tpu_torch.config import parse_args\n"
        "cfg = parse_args(['configs/arguments_test_nyu.txt'])\n"
        "bts = sorted(m for m in sys.modules if m == 'bts_tpu' or m.startswith('bts_tpu.'))\n"
        "print(json.dumps({'jax': 'jax' in sys.modules, 'flax': 'flax' in sys.modules,\n"
        "  'bts_tpu': bts,\n"
        "  'flavor': cfg.model_flavor, 'norm': cfg.resolved_normalization,\n"
        "  'encoder': cfg.encoder}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "jax": False, "flax": False, "bts_tpu": [], "flavor": "pt", "norm": "imagenet",
        "encoder": "densenet161_bts",
    }


def test_parse_args_device_and_checks(tmp_path):
    cfg, device = parse_args_with_device(["--device", "cpu", "--normalization", "caffe"])
    assert device == "cpu" and cfg.normalization == "caffe"
    assert parse_args_with_device([])[1] == ""
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        parse_args(["--encoder", "resnet50_bts"])
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        parse_args(["--model_flavor", "tf"])
    with pytest.raises(NotImplementedError, match="queue 2, item 4"):
        parse_args(["--lpg_impl", "ffi"])
    with pytest.raises(ValueError, match="lpg_impl"):
        parse_args(["--lpg_impl", "triton"])
    with pytest.raises(ValueError, match="dataset"):
        parse_args(["--dataset", "nyuv2"])
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        parse_args(["--checkpoint_path", str(tmp_path)])
    (tmp_path / "model.index").write_text("")
    with pytest.raises(NotImplementedError, match="TF checkpoint"):
        parse_args(["--checkpoint_path", str(tmp_path / "model")])
