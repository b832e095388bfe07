"""Run-provenance snapshot: ``bts_tpu/training/snapshot.py``.

The reference copies its model, loader and driver sources and the args file
into log_directory/model_name at train start, so each checkpoint is
evaluated with the code that produced it (pytorch/bts_main.py:560-586). The
port snapshots the whole ``bts_tpu_torch`` package (kernel sources included,
built libraries not) and the resolved config.
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
from typing import Optional

from bts_tpu_torch.config import Config, config_to_argfile

PACKAGE = "bts_tpu_torch"


def _package_root() -> str:
    """The directory that holds the live ``bts_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__ + "/..")))


def snapshot_run(cfg: Config, argv=None) -> str:
    """Copy the package and the config into log_directory/model_name; returns
    that run directory."""
    run_dir = os.path.join(cfg.log_directory or ".", cfg.model_name)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "arguments.txt"), "w") as f:
        f.write(config_to_argfile(cfg))
    if argv:
        with open(os.path.join(run_dir, "argv.txt"), "w") as f:
            f.write(" ".join(argv) + "\n")
    src = os.path.join(_package_root(), PACKAGE)
    dst = os.path.join(run_dir, PACKAGE)
    if os.path.realpath(src) != os.path.realpath(dst):
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    return run_dir


def find_run_dir(cfg: Config) -> Optional[str]:
    """The run directory holding a package snapshot for this config:
    checkpoint_path itself, its parent (checkpoints live inside the run
    dir), then log_directory/model_name."""
    candidates = []
    if cfg.checkpoint_path:
        cp = cfg.checkpoint_path.rstrip("/")
        candidates += [cp, os.path.dirname(cp)]
    if cfg.log_directory and cfg.model_name:
        candidates.append(os.path.join(cfg.log_directory, cfg.model_name))
    for c in candidates:
        if c and os.path.isdir(os.path.join(c, PACKAGE)):
            return c
    return None


def activate_snapshot(run_dir: str) -> bool:
    """Switch later ``bts_tpu_torch`` imports to the snapshot in ``run_dir``
    (the reference's dynamic import of the snapshot, pytorch/bts_main.py:125-133).
    True if the import root was switched (the caller re-imports and
    re-dispatches); False when there is no snapshot or this process already
    runs from it."""
    if not os.path.isdir(os.path.join(run_dir, PACKAGE)):
        return False
    if os.path.realpath(_package_root()) == os.path.realpath(run_dir):
        return False
    sys.path.insert(0, run_dir)
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    importlib.invalidate_caches()
    return True
