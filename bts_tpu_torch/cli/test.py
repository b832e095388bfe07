"""CLI: prediction dump -- ``python -m bts_tpu_torch.cli.test <argfile>``.

Runs on the CUDA card (the LPG and fused dense-layer kernels included).
Without a card it fails, unless ``--device cpu`` asks for the plain PyTorch
ops on the CPU (tests). A checkpoint inside a run directory that holds a code
snapshot is served with that snapshot's code (the reference's dynamic
import, pytorch/bts_test.py:68-74).
"""

import importlib
import sys

import torch

from bts_tpu_torch.apps.predict import run_predictions
from bts_tpu_torch.config import parse_args_with_device


def resolve_device(name: str) -> torch.device:
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return device


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = parse_args_with_device(argv)

    from bts_tpu_torch.training.snapshot import activate_snapshot, find_run_dir

    run_dir = find_run_dir(cfg)
    if run_dir and activate_snapshot(run_dir):
        print(f"Using model snapshot from {run_dir}")
        return importlib.import_module("bts_tpu_torch.cli.test").main(argv)

    run_predictions(cfg, resolve_device(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
