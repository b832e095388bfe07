"""CLI: PNG-vs-PNG evaluation -- ``python -m bts_tpu_torch.cli.eval_with_pngs``
(the reference's utils/eval_with_pngs.py). Host only: it reads the
predictions under ``--pred_path`` and the gt under ``--gt_path``."""

import sys

from bts_tpu_torch.config import parse_args
from bts_tpu_torch.evaluation.png_eval import eval_pngs


def main(argv=None) -> int:
    eval_pngs(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
