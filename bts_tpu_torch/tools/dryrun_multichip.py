"""Data-parallel dry run: ``python -m bts_tpu_torch.tools.dryrun_multichip N
[--device cpu]`` (``__graft_entry__.dryrun_multichip`` for the port).

N ranks (``parallel/launch.py``: one a card, or N gloo ranks on the CPU
with ``--device cpu``) each take one sample of a global batch of N through
MobileNetV2-BTS at 32x64 (``bts_size 128``): two train steps (global-batch
BN, the global silog loss, DDP's averaged gradients), then the device-eval
metric sums of their predictions added over the ranks by an all-reduce.
Then this process runs the trained weights through ``make_sharded_forward``
over the N devices. It prints ``dryrun_multichip(N): step ok, loss=...``,
``infer ok`` and ``eval ok, count=N``, and exits 0.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from bts_tpu_torch.config import Config

H, W = 32, 64  # the smallest stride-32 frame of bts_tpu's dry run


def dryrun_config(n: int) -> Config:
    return Config(encoder="mobilenetv2_bts", dataset="nyu", max_depth=10.0, batch_size=n,
                  input_height=H, input_width=W, bts_size=128, min_depth_eval=1e-3,
                  max_depth_eval=10.0)


def global_batch(n: int) -> dict:
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 9.5, size=(n, H, W, 1)).astype(np.float32),
            "focal": np.full((n,), 518.8579, np.float32)}


def rank_main(cfg: Config, dp) -> dict:
    """One rank: two train steps on its sample, then the eval sums."""
    from bts_tpu_torch.evaluation.device_eval import make_batch_metrics
    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.parallel.mesh import local_slice
    from bts_tpu_torch.training.optim import create_optimizer
    from bts_tpu_torch.training.state import TrainState, make_train_step, to_device

    model = create_model(cfg).to(dp.device)
    optimizer, _ = create_optimizer(cfg, model, 1000)
    state = TrainState(model, optimizer)
    step = make_train_step(cfg, dp)
    local = local_slice(global_batch(dp.world), dp.world, dp.rank)
    batch = to_device(local, dp.device)
    losses = [float(step(state, batch)) for _ in range(2)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"rank {dp.rank}: non-finite losses {losses}")

    model.eval()
    with torch.no_grad():
        depth = model(batch["image"].permute(0, 3, 1, 2), batch["focal"])[-1][:, 0]
    gt_raw = np.round(local["depth"][..., 0] * 1000.0).astype(np.uint16)
    sums, count = make_batch_metrics(cfg)(depth, gt_raw, np.ones(len(gt_raw), np.float32))
    total = torch.tensor([*sums, count], dtype=torch.float64,
                         device="cpu" if dist.get_backend() == "gloo" else dp.device)
    dist.all_reduce(total)
    total = total.cpu().numpy()
    return {"losses": losses, "sums": total[:9], "count": float(total[9]),
            "state": {k: v.cpu() for k, v in model.state_dict().items()} if dp.rank == 0
            else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, help="ranks (one sample each)")
    parser.add_argument("--device", default="", help="'cpu' for gloo ranks on the CPU")
    args = parser.parse_args(argv)
    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.parallel import launch
    from bts_tpu_torch.parallel.inference import make_sharded_forward

    n = args.n
    devices = ["cpu"] * n if args.device == "cpu" else launch.default_devices(n)
    cfg = dryrun_config(n)
    results = launch.spawn(rank_main, cfg, n, devices=devices)
    losses = results[0]["losses"]
    if any(r["losses"] != losses for r in results):
        raise RuntimeError(f"the ranks' losses differ: {[r['losses'] for r in results]}")
    print(f"dryrun_multichip({n}): step ok, loss={losses[0]:.4f}")

    model = create_model(cfg)
    model.load_state_dict(results[0]["state"])
    batch = global_batch(n)
    image = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2)
    depths = make_sharded_forward(model, devices, cfg)(image, torch.from_numpy(batch["focal"]))
    if [tuple(d.shape) for d in depths] != [(1, H, W)] * n or not all(
            bool(torch.isfinite(d).all()) for d in depths):
        raise RuntimeError(f"sharded forward: {[tuple(d.shape) for d in depths]}")
    print(f"dryrun_multichip({n}): infer ok")

    count = results[0]["count"]
    if int(round(count)) != n or not np.isfinite(results[0]["sums"]).all():
        raise RuntimeError(f"eval sums {results[0]['sums']}, count {count}")
    print(f"dryrun_multichip({n}): eval ok, count={int(round(count))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
