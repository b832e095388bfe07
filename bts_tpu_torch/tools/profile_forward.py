"""Where a forward's time goes on the card: ``python -m bts_tpu_torch.tools.profile_forward``.

DenseNet161-BTS NYU at full width (``bts_size`` 512), 480x640, seeded
weights, in the PT graph or (``--model_flavor tf``) the TF graph, under ``inference_mode`` in ``--dtype`` bfloat16 (autocast, the
default) or float32 (``cli.test``'s default dtype; TF32 off in cuDNN and
cuBLAS, so the plain convs are f32 too); at each batch the dense layers run
in turns plain, ``--dense_impl`` (auto, the taps kernel, by default; or eo),
twice, and plain. For each
run: ``torch.profiler`` over 3 forwards gives the kernels per forward, the
device time per forward and its split by kind of kernel; the wall time per
forward comes from 10 forwards without the profiler, host clock around work
that ends in a synchronise. Idle is 1 - device time / wall time; the 12
kernels that take the most device time are listed by name. Prints one
line per run and writes them as JSON to ``--out``
(``build/profile_forward.json`` by default).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

# Kinds of kernel, by the first pattern found in the lower-cased name.
KINDS = (
    ("fused dense", ("taps_sm90", "taps_f32")),  # both forms' kernels
    ("lpg", ("lpg_",)),
    ("cat", ("catarray", "cat_")),
    ("bn", ("batch_norm", "batchnorm", "bn_")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_")),
    ("layout", ("nchw", "nhwc", "transpose", "permute", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("pool", ("pool",)),
)


def kind(name: str) -> str:
    low = name.lower()
    for label, patterns in KINDS:
        if any(p in low for p in patterns):
            return label
    return "other"


def profile_run(model, x, focal, dense_impl, bf16=True, forwards=3, timed=10):
    model.encoder.dense_impl = dense_impl
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
        for _ in range(3):
            model(x, focal)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(forwards):
                model(x, focal)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            model(x, focal)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    kernels, device_us, by_kind, by_name = 0, 0.0, {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        device_us += us
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / forwards
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / forwards
    device_ms = device_us / 1e3 / forwards
    return {
        "batch": x.shape[0], "dtype": "bfloat16" if bf16 else "float32",
        "dense_impl": dense_impl, "kernels": kernels // forwards,
        "device_ms": device_ms, "wall_ms": wall_ms, "idle": 1.0 - device_ms / wall_ms,
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[8, 1])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--dense_impl", choices=("auto", "eo"), default="auto",
                        help="the fused dense layers' form, timed against plain")
    parser.add_argument("--model_flavor", choices=("pt", "tf"), default="pt",
                        help="the reference's PyTorch graph or its TF graph")
    parser.add_argument("--out", default=os.path.join("build", "profile_forward.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    bf16 = args.dtype == "bfloat16"
    if not bf16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=10.0, bts_size=512,
                 model_flavor=args.model_flavor)
    model = create_model(cfg).cuda().eval()
    gen = torch.Generator().manual_seed(1)
    runs = []
    for b in args.batches:
        x = torch.randn(b, 3, 480, 640, generator=gen).cuda()
        focal = torch.full((b,), 518.8579, device="cuda")
        for dense_impl in ("plain", args.dense_impl, args.dense_impl, "plain"):
            run = profile_run(model, x, focal, dense_impl, bf16)
            run["model_flavor"] = args.model_flavor
            run["device"] = smi
            runs.append(run)
            print(json.dumps(run), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
