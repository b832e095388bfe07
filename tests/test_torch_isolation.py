"""bts_tpu_torch never loads jax, flax, orbax, tensorflow or anything of
bts_tpu: every slice module, and parsing the NYU test args file (whose
--checkpoint_path would make bts_tpu's Config.validate sniff it through
jax-backed modules) and a TF-flavor one. In a subprocess, because
tests/conftest.py imports jax in this one.

Also: an installed package carries every file its kernels' sources include,
and builds them outside the package's directory.
"""

import fnmatch
import json
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from bts_tpu_torch.config import parse_args, parse_args_with_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "bts_tpu_torch",
    "bts_tpu_torch.config",
    "bts_tpu_torch.ops",
    "bts_tpu_torch.ops.lpg",
    "bts_tpu_torch.ops.lpg_cuda",
    "bts_tpu_torch.ops.lpg_cpu",
    "bts_tpu_torch.ops.fused_dense",
    "bts_tpu_torch.ops.fused_dense_cuda",
    "bts_tpu_torch.ops._build",
    "bts_tpu_torch.data",
    "bts_tpu_torch.data.manifest",
    "bts_tpu_torch.data.transforms",
    "bts_tpu_torch.data.loader",
    "bts_tpu_torch.data.device_augment",
    "bts_tpu_torch.data.tools",
    "bts_tpu_torch.data.tools.download",
    "bts_tpu_torch.data.tools.extract_nyu",
    "bts_tpu_torch.data.tools.make_manifests",
    "bts_tpu_torch.utils",
    "bts_tpu_torch.utils.colorize",
    "bts_tpu_torch.models",
    "bts_tpu_torch.models.layers",
    "bts_tpu_torch.models.encoders.densenet",
    "bts_tpu_torch.models.encoders.resnet",
    "bts_tpu_torch.models.encoders.mobilenet",
    "bts_tpu_torch.models.decoder",
    "bts_tpu_torch.models.bts",
    "bts_tpu_torch.models.convert",
    "bts_tpu_torch.models.convert_tf",
    "bts_tpu_torch.apps.predict",
    "bts_tpu_torch.apps.sequence",
    "bts_tpu_torch.apps.live3d",
    "bts_tpu_torch.apps.live3d_gl",
    "bts_tpu_torch.cli.test",
    "bts_tpu_torch.cli.train",
    "bts_tpu_torch.cli.sequence",
    "bts_tpu_torch.cli.live3d",
    "bts_tpu_torch.cli.avg_checkpoints",
    "bts_tpu_torch.training",
    "bts_tpu_torch.training.loss",
    "bts_tpu_torch.training.lr",
    "bts_tpu_torch.training.optim",
    "bts_tpu_torch.training.state",
    "bts_tpu_torch.training.checkpoint",
    "bts_tpu_torch.training.preempt",
    "bts_tpu_torch.training.snapshot",
    "bts_tpu_torch.training.loop",
    "bts_tpu_torch.evaluation",
    "bts_tpu_torch.evaluation.metrics",
    "bts_tpu_torch.evaluation.protocol",
    "bts_tpu_torch.evaluation.png_eval",
    "bts_tpu_torch.evaluation.device_eval",
    "bts_tpu_torch.evaluation.online",
    "bts_tpu_torch.evaluation.offline",
    "bts_tpu_torch.evaluation.schedule",
    "bts_tpu_torch.cli.eval",
    "bts_tpu_torch.cli.eval_with_pngs",
    "bts_tpu_torch.cli.eval_schedule",
    "bts_tpu_torch.tools.profile_forward",
    "bts_tpu_torch.tools.profile_train",
    "bts_tpu_torch.tools.reproduce_reference",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from bts_tpu_torch.config import parse_args\n"
        "cfg = parse_args(['configs/arguments_test_nyu.txt'])\n"
        "tf_cfg = parse_args(['@configs/arguments_test_nyu.txt', '--model_flavor', 'tf'])\n"
        "bts = sorted(m for m in sys.modules if m == 'bts_tpu' or m.startswith('bts_tpu.'))\n"
        "print(json.dumps({m: m in sys.modules for m in ('jax', 'flax', 'orbax', 'tensorflow')}\n"
        "  | {'bts_tpu': bts,\n"
        "  'flavor': cfg.model_flavor, 'norm': cfg.resolved_normalization,\n"
        "  'encoder': cfg.encoder, 'tf': [tf_cfg.model_flavor, tf_cfg.normalization]}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "jax": False, "flax": False, "orbax": False, "tensorflow": False, "bts_tpu": [],
        "flavor": "pt", "norm": "imagenet", "encoder": "densenet161_bts",
        "tf": ["tf", "caffe"],
    }


def test_parse_args_device_and_checks(tmp_path, monkeypatch):
    cfg, device = parse_args_with_device(["--device", "cpu", "--normalization", "caffe"])
    assert device == "cpu" and cfg.normalization == "caffe"
    assert parse_args_with_device([])[1] == ""
    with pytest.raises(ValueError, match="unknown encoder 'resnet152_bts'"):
        parse_args(["--encoder", "resnet152_bts"])
    tf = parse_args(["--model_flavor", "tf"])
    assert (tf.model_flavor, tf.normalization) == ("tf", "caffe")
    assert parse_args(["--lpg_impl", "ffi"]).lpg_impl == "ffi"
    with pytest.raises(ValueError, match="lpg_impl"):
        parse_args(["--lpg_impl", "triton"])
    with pytest.raises(ValueError, match="dataset"):
        parse_args(["--dataset", "nyuv2"])
    with pytest.raises(NotImplementedError, match="scripts/export_orbax_to_pth.py"):
        parse_args(["--checkpoint_path", str(tmp_path)])
    # A TF prefix is read (its flavor sniffed) with tensorflow, and without
    # it the sniff raises naming tensorflow: never taken for the PT graph.
    (tmp_path / "model.index").write_text("")
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "tensorflow", None)
        with pytest.raises(ImportError, match="tensorflow"):
            parse_args(["--checkpoint_path", str(tmp_path / "model")])
    assert parse_args(["--checkpoint_path", str(tmp_path / "model"),
                       "--model_flavor", "tf"]).resolved_flavor == "tf"


def test_every_csrc_include_is_package_data():
    """Each local ``#include "..."`` under csrc/ matches a package-data glob,
    so an installed package can build its kernels."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["bts_tpu_torch"]
    csrc = Path(ROOT) / "bts_tpu_torch" / "csrc"
    shipped = {p.relative_to(csrc.parent).as_posix() for p in csrc.iterdir()
               if any(fnmatch.fnmatch(p.relative_to(csrc.parent).as_posix(), g) for g in globs)}
    assert {p.relative_to(csrc.parent).as_posix() for p in csrc.glob("*.cu")} <= shipped
    includes = {(src.name, name) for src in csrc.iterdir() if src.suffix in (".cu", ".cuh")
                for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M)}
    assert includes, "the kernels include a shared header"
    for src, name in includes:
        assert f"csrc/{name}" in shipped, f"{src} includes {name}, which is not package data"


def test_build_dir_in_a_checkout_and_installed(tmp_path, monkeypatch):
    from bts_tpu_torch.ops import _build

    assert _build.BUILD_DIR == Path(ROOT) / "build" / "kernels"
    site = tmp_path / "site-packages"  # an installed package's parent: no pyproject.toml
    site.mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(site) == tmp_path / "cache" / "bts_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(site) == tmp_path / "home" / ".cache" / "bts_tpu_torch" / "kernels"
