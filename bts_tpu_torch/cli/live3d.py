"""CLI: live 3D demo, the reference's {pytorch,tensorflow}/bts_live_3d.py.

Two modes:
  * ``--image_dir DIR [--out_dir DIR]``: headless; renders point-cloud views
    of every frame in DIR to pngs (no GUI stack needed);
  * no ``--image_dir``: the interactive webcam viewer (needs cv2, Qt and
    OpenGL).

The depth runs on the CUDA card; without one it fails, unless ``--device
cpu`` asks for the plain PyTorch ops on the CPU.
"""

import sys

from bts_tpu_torch.cli.sequence import take_flag
from bts_tpu_torch.config import parse_args_with_device


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    image_dir = take_flag(argv, "--image_dir")
    out_dir = take_flag(argv, "--out_dir") or ""
    cfg, device = parse_args_with_device(argv)

    from bts_tpu_torch.apps.live3d import main as live3d_main
    from bts_tpu_torch.apps.live3d import run_headless
    from bts_tpu_torch.cli.test import resolve_device

    device = resolve_device(device)
    if image_dir:
        n = run_headless(cfg, image_dir, out_dir, device=device)
        print(f"Rendered {n} frames")
        return 0
    return live3d_main(cfg, device)


if __name__ == "__main__":
    sys.exit(main())
