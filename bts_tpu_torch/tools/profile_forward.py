"""Where a forward's time goes on the card: ``python -m bts_tpu_torch.tools.profile_forward``.

The model of ``--encoder`` (any name of the zoo; DenseNet161-BTS by
default) for NYU at full width (``bts_size`` 512), 480x640, seeded
weights, in the PT graph or (``--model_flavor tf``) the TF graph, under ``inference_mode`` in ``--dtype`` bfloat16 (autocast, the
default) or float32 (``cli.test``'s default dtype; TF32 off in cuDNN and
cuBLAS, so the plain convs are f32 too). A model with fused dense layers (a
DenseNet encoder's ``dense_impl``) runs them at each batch in turns plain,
``--dense_impl`` (auto, the taps kernel, by default; or eo), twice, and
plain. Any other model (``--encoder large07``, NeWCRFs; ``dav2_vitl``,
Depth Anything V2) runs at each batch in turns its eager forward
(``model._forward``, so that spans such as ``newcrfs/encoder`` and
``newcrfs/decoder``, or ``dav2/encoder`` and ``dav2/head``, show; the
device ms a forward of the kernels inside each is listed), its replayed
forward twice, and the eager forward. For each
run: ``torch.profiler`` over 3 forwards gives the kernels per forward, the
launches of each kernel name per forward (``launches``), the
device time per forward and its split by kind of kernel; the wall time per
forward comes from 10 forwards without the profiler, host clock around work
that ends in a synchronise. Idle is 1 - device time / wall time; the 12
kernels that take the most device time are listed by name. Prints one
line per run, writes them as JSON to ``--out``
(``build/profile_forward.json`` by default) and returns them.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from bts_tpu_torch.tools.benchtools import card

# Kinds of kernel, by the first pattern found in the lower-cased name.
KINDS = (
    ("fused dense", ("taps_sm90", "taps_f32")),  # both forms' kernels
    ("window attention", ("window_attn",)),
    ("global attention", ("global_attn",)),
    ("lpg", ("lpg_",)),
    ("cat", ("catarray", "cat_")),
    ("bn", ("batch_norm", "batchnorm", "bn_")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_")),
    ("layout", ("nchw", "nhwc", "transpose", "permute", "copy")),
    ("norm", ("layer_norm", "group_norm")),  # ahead of PyTorch's "vectorized_layer_norm"
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("pool", ("pool",)),
)


def kind(name: str) -> str:
    low = name.lower()
    for label, patterns in KINDS:
        if any(p in low for p in patterns):
            return label
    return "other"


def profile_run(model, x, focal, dense_impl, bf16=True, forwards=3, timed=10, eager=False):
    """``dense_impl`` None: the model has no dense layers. ``eager``: the
    eager forward is profiled, not the call (a replay from its second)."""
    if dense_impl is not None:
        model.encoder.dense_impl = dense_impl
    forward = "eager" if eager else "replay"
    if eager:
        model = model._forward
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
    kernels, device_us, by_kind, by_name, spans, launches = 0, 0.0, {}, {}, {}, {}
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # The record_function spans appear on the card too, as annotations around
    # their kernels: a model's own (NeWCRFs's halves) and the graph's replay
    # (``bts/forward_graph``) around a replayed forward's kernels.
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in on_card
              if e.is_user_annotation]
    for e in on_card:
        if e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        for name, start, end in ranges:
            if start <= e.time_range.start < end:
                spans[name] = spans.get(name, 0.0) + us / 1e3 / forwards
        device_us += us
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
            launches[e.name] = launches.get(e.name, 0) + 1
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3 / forwards
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / forwards
    device_ms = device_us / 1e3 / forwards
    return {
        "batch": x.shape[0], "dtype": "bfloat16" if bf16 else "float32",
        "dense_impl": dense_impl, "forward": forward, "kernels": kernels // forwards,
        "device_ms": device_ms, "wall_ms": wall_ms, "idle": 1.0 - device_ms / wall_ms,
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
        **({"spans_ms": spans} if spans else {}),
        "launches": {k: n / forwards for k, n in sorted(launches.items())},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--encoder", default="densenet161_bts", help="a name of the zoo")
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
    from bts_tpu_torch.models import create_model

    smi = card(torch.device("cuda"))
    print(smi, flush=True)
    cfg = Config(encoder=args.encoder, dataset="nyu", max_depth=10.0, bts_size=512,
                 model_flavor=args.model_flavor)
    model = create_model(cfg).cuda().eval()
    # (dense_impl, eager) of each run at a batch, in turns.
    turns = (tuple((impl, False) for impl in ("plain", args.dense_impl, args.dense_impl,
                                              "plain"))
             if hasattr(getattr(model, "encoder", None), "dense_impl")
             else ((None, True), (None, False), (None, False), (None, True)))
    gen = torch.Generator().manual_seed(1)
    runs = []
    for b in args.batches:
        x = torch.randn(b, 3, 480, 640, generator=gen).cuda()
        focal = torch.full((b,), 518.8579, device="cuda")
        for dense_impl, eager in turns:
            run = profile_run(model, x, focal, dense_impl, bf16, eager=eager)
            run["model_flavor"] = args.model_flavor
            run["device"] = smi
            runs.append(run)
            print(json.dumps(run), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
