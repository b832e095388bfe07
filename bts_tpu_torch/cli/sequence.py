"""CLI: directory inference, the reference's tensorflow/bts_sequence.py.

    python -m bts_tpu_torch.cli.sequence --image_dir DIR [--out_dir DIR] [flags | @argfile]

Runs on the CUDA card; without one it fails, unless ``--device cpu`` asks
for the plain PyTorch ops on the CPU.
"""

import sys

from bts_tpu_torch.config import parse_args_with_device


def take_flag(argv, flag):
    """Remove ``flag VALUE`` from ``argv`` (in place) and return VALUE, or
    None when ``flag`` is absent."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    image_dir = take_flag(argv, "--image_dir")
    out_dir = take_flag(argv, "--out_dir")
    cfg, device = parse_args_with_device(argv)
    if not image_dir:
        print("--image_dir is required")
        return 1

    from bts_tpu_torch.apps.sequence import run_sequence
    from bts_tpu_torch.cli.test import resolve_device

    n = run_sequence(cfg, image_dir, out_dir, device=resolve_device(device))
    print(f"Processed {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
