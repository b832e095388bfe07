"""CLI: prediction dump -- ``python -m bts_tpu_torch.cli.test <argfile>``.

Runs on the CUDA card (the LPG and fused dense-layer kernels included).
Without a card it fails, unless ``--device cpu`` asks for the plain PyTorch
ops on the CPU (tests).
"""

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
    cfg, device = parse_args_with_device(sys.argv[1:] if argv is None else argv)
    run_predictions(cfg, resolve_device(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
