"""CLI: training -- ``python -m bts_tpu_torch.cli.train <argfile>``.

Runs on the CUDA card; without one it fails, unless ``--device cpu`` asks
for the plain PyTorch ops on the CPU (tests). A ``--checkpoint_path`` inside
a run directory continues with that run's code snapshot (the reference's
conditional dynamic import, pytorch/bts_main.py:125-133), before any rank
starts.

Data parallelism (``parallel/``): ``--num_devices N`` starts N ranks, one a
card (``0``, the default, means every card of the host: one process on a
one-card host); ``--device cpu --num_devices N`` starts N gloo ranks on the
CPU; ``--device cuda:0,cuda:0 --dist_backend gloo`` puts two ranks on one
card. Under torchrun, SLURM or Open MPI (``mesh.maybe_init_distributed``)
this process joins the launcher's group as one rank instead, on its local
rank's card (``--device cpu``: gloo on the CPU; no card raises). The step is
the global batch's whatever the ranks (``--batch_size`` is global).
"""

import importlib
import sys

from bts_tpu_torch.config import Config, parse_args_with_device


def run_rank(cfg: Config, dp) -> int:
    """One rank's training (``parallel.launch.spawn``'s ``fn``)."""
    from bts_tpu_torch.training.loop import train

    return train(cfg, dp=dp)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = parse_args_with_device(argv)
    if cfg.mode != "train":
        print("cli.train is only for training. Use cli.test instead.")
        return -1
    from bts_tpu_torch.models import check_trainable, model_class

    check_trainable(model_class(cfg.encoder))
    if cfg.checkpoint_path:
        from bts_tpu_torch.training.snapshot import activate_snapshot, find_run_dir

        run_dir = find_run_dir(cfg)
        if run_dir and activate_snapshot(run_dir):
            print(f"Using model snapshot from {run_dir}")
            return importlib.import_module("bts_tpu_torch.cli.train").main(argv)

    from bts_tpu_torch.cli.test import resolve_device
    from bts_tpu_torch.parallel import launch, mesh
    from bts_tpu_torch.training.loop import train

    if mesh.maybe_init_distributed(device=device):
        dp = mesh.init_data_parallel(mesh.env_device(device))
        return 0 if run_rank(cfg, dp) >= 0 else -1
    devices = launch.rank_devices(device, cfg.num_devices)
    if len(devices) > 1:
        results = launch.spawn(run_rank, cfg.replace(num_devices=len(devices)), len(devices),
                               devices=devices)
        return 0 if all(r >= 0 for r in results) else -1
    return 0 if train(cfg, device=resolve_device(devices[0])) >= 0 else -1


if __name__ == "__main__":
    sys.exit(main())
