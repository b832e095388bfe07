"""Where a train step's time goes on the card: ``python -m bts_tpu_torch.tools.profile_train``.

The NYU recipe's step (``configs/arguments_train_nyu.txt``): DenseNet161-BTS
at full width, seeded weights, 416x544 crops of raw 427x565 frames by the
device augmentation, the silog loss, the backward (dense layers ``plain``,
LPG by its kernels) and AdamW, in ``--dtype`` bfloat16 (autocast, the
default) or float32 (TF32 off). At each batch: 3 warm-up steps, then
``torch.profiler`` over 3 steps gives the kernels per step, the device time
per step and its split by kind of kernel, and the host time spent in each of
the step's ranges (``train_step/augment``, ``/forward``, ``/backward``,
``/optimizer``); the wall time per step comes from 10 steps without the
profiler, host clock around work that ends in a synchronise, and the peak
memory they allocate. Idle is 1 - device time / wall time. ``--remat``,
``--remat_policy`` and ``--remat_scope`` rematerialise as ``cli.train``
does. Prints one JSON line per batch and writes them to ``--out``
(``build/profile_train.json`` by default). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from bts_tpu_torch.tools.benchtools import card
from bts_tpu_torch.tools.profile_forward import kind

RANGES = ("train_step/augment", "train_step/forward", "train_step/backward",
          "train_step/optimizer")


def top_kernels(prof, steps: int, n: int = 12) -> dict:
    """The n kernels with the most device time a step, by name."""
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in RANGES:
            ms[e.name[:80]] = ms.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def profile_step(batch: int, bf16: bool, steps: int = 3, timed: int = 10, **remat) -> dict:
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.training.optim import create_optimizer
    from bts_tpu_torch.training.state import TrainState, make_train_step

    cfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=10.0, bts_size=512,
                 learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=batch,
                 input_height=416, input_width=544, device_augment=True,
                 compute_dtype="bfloat16" if bf16 else "float32", **remat)
    model = create_model(cfg).cuda()
    optimizer, _ = create_optimizer(cfg, model, 1000)
    state = TrainState(model, optimizer)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(8)
    dev = {"image": torch.rand(batch, 427, 565, 3, generator=gen).cuda(),
           "depth": (torch.rand(batch, 427, 565, 1, generator=gen) * 9.5 + 0.05).cuda(),
           "focal": torch.full((batch,), 518.8579, device="cuda")}
    for _ in range(3):
        step(state, dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(state, dev)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state, dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    peak_bytes = torch.cuda.max_memory_allocated()

    kernels, device_us, by_kind, host_us = 0, 0.0, {}, {}
    for e in prof.events():
        if e.name in RANGES:
            # A range shows twice: on the host, and as an annotation over the
            # device timeline that spans kernels; only the host side counts.
            if e.device_type == torch.autograd.DeviceType.CPU:
                name = e.name.removeprefix("train_step/")
                host_us[name] = host_us.get(name, 0.0) + e.time_range.elapsed_us()
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        device_us += us
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / steps
    host_ms = {k: v / 1e3 / steps for k, v in host_us.items()}
    device_ms = device_us / 1e3 / steps
    return {
        "batch": batch, "dtype": cfg.compute_dtype, "kernels": kernels // steps,
        "remat": (f"{cfg.remat_policy}/{cfg.remat_scope}" if cfg.remat else "off"),
        "device_ms": device_ms, "wall_ms": wall_ms, "idle": 1.0 - device_ms / wall_ms,
        "peak_bytes": peak_bytes,
        "img_per_s": batch / wall_ms * 1e3, "host_ms_by_range": host_ms,
        "top_kernels_ms": top_kernels(prof, steps),
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[4, 16])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--remat", action="store_true",
                        help="recompute activations in the backward to save memory")
    parser.add_argument("--remat_policy", default="conv", choices=("conv", "full"))
    parser.add_argument("--remat_scope", default="encoder", choices=("encoder", "all"))
    parser.add_argument("--out", default=os.path.join("build", "profile_train.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    bf16 = args.dtype == "bfloat16"
    if not bf16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    smi = card(torch.device("cuda"))
    print(smi, flush=True)
    runs = []
    for b in args.batches:
        run = profile_step(b, bf16, remat=args.remat, remat_policy=args.remat_policy,
                           remat_scope=args.remat_scope)
        run["device"] = smi
        runs.append(run)
        print(json.dumps(run), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
