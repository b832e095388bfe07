"""CLI: continuous eval -- ``python -m bts_tpu_torch.cli.eval_schedule <argfile>``
(the reference's run_bts_eval_schedule.py): ``cli.eval``'s work every
minute, on the CUDA card unless ``--device cpu``."""

import sys

from bts_tpu_torch.cli.test import resolve_device
from bts_tpu_torch.config import parse_args_with_device
from bts_tpu_torch.evaluation.schedule import run_schedule


def main(argv=None) -> int:
    cfg, device = parse_args_with_device(sys.argv[1:] if argv is None else argv)
    run_schedule(cfg, device=resolve_device(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
