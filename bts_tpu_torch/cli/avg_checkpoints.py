"""CLI: average N checkpoints into an inference checkpoint.

``bts_tpu/cli/avg_checkpoints.py`` for the port's ``.pth`` files: an
SWA-style eval helper with no reference equivalent (the reference keeps
per-metric best checkpoints, pytorch/bts_main.py:513-539, and never combines
them). Typical use: average the last K ``model-{step}`` files (or several
best-metric ones) of a run and point ``cli.test`` or ``cli.eval`` at the
result. Reads port and reference ``.pth`` files; runs on the host only.

    python -m bts_tpu_torch.cli.avg_checkpoints --out avg.pth run/model-4000 \\
        run/model-4500 run/model-5000
"""

from __future__ import annotations

import argparse
import sys

from bts_tpu_torch.training.checkpoint import average_checkpoints, save_params_only


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Average checkpoints into an inference .pth")
    parser.add_argument("--out", required=True, help="output checkpoint file")
    parser.add_argument("checkpoints", nargs="+", help="input checkpoint files")
    args = parser.parse_args(argv)
    save_params_only(args.out, average_checkpoints(args.checkpoints))
    print(f"Averaged {len(args.checkpoints)} checkpoints -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
