"""CLI: training -- ``python -m bts_tpu_torch.cli.train <argfile>``.

Runs on the CUDA card; without one it fails, unless ``--device cpu`` asks
for the plain PyTorch ops on the CPU (tests). A ``--checkpoint_path`` inside
a run directory continues with that run's code snapshot (the reference's
conditional dynamic import, pytorch/bts_main.py:125-133).
"""

import importlib
import sys

from bts_tpu_torch.config import parse_args_with_device


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = parse_args_with_device(argv)
    if cfg.mode != "train":
        print("cli.train is only for training. Use cli.test instead.")
        return -1
    if cfg.checkpoint_path:
        from bts_tpu_torch.training.snapshot import activate_snapshot, find_run_dir

        run_dir = find_run_dir(cfg)
        if run_dir and activate_snapshot(run_dir):
            print(f"Using model snapshot from {run_dir}")
            return importlib.import_module("bts_tpu_torch.cli.train").main(argv)

    from bts_tpu_torch.cli.test import resolve_device
    from bts_tpu_torch.training.loop import train

    return 0 if train(cfg, device=resolve_device(device)) >= 0 else -1


if __name__ == "__main__":
    sys.exit(main())
