"""CLI: offline checkpoint eval -- ``python -m bts_tpu_torch.cli.eval <argfile>``
(the reference's pytorch/bts_eval.py).

Evaluates the ``model-<step>`` checkpoints of ``<log_directory>/<model_name>``
that its ledger does not list yet, on the CUDA card; without one it fails,
unless ``--device cpu`` asks for the plain PyTorch ops on the CPU. A run
directory that holds a code snapshot is evaluated with that snapshot's code
(the reference's dynamic import, pytorch/bts_eval.py:72-78).
"""

import importlib
import sys

from bts_tpu_torch.config import parse_args_with_device


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = parse_args_with_device(argv)

    from bts_tpu_torch.training.snapshot import activate_snapshot, find_run_dir

    run_dir = find_run_dir(cfg)
    if run_dir and activate_snapshot(run_dir):
        print(f"Using model snapshot from {run_dir}")
        return importlib.import_module("bts_tpu_torch.cli.eval").main(argv)

    from bts_tpu_torch.cli.test import resolve_device
    from bts_tpu_torch.evaluation.offline import eval_summary_writer, evaluate_pending

    device = resolve_device(device)
    writer = eval_summary_writer(cfg)
    try:
        evaluate_pending(cfg, writer=writer, device=device)
    finally:
        if writer is not None:
            writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
