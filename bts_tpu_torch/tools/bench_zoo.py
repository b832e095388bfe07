"""Inference throughput of each encoder on the card: ``python -m bts_tpu_torch.tools.bench_zoo [encoder ...]``.

The port's counterpart of ``scripts/bench_zoo.py``, with its flags and
defaults: every encoder of ``ZOO`` (or those named), NYU (``--dataset
kitti``: ``max_depth`` 80), seeded weights, 480x640, batch 128 (the
script's default), bf16 autocast under ``inference_mode``, the dense layers
and the LPG at ``auto`` (the taps kernel for the two DenseNets, the LPG
kernel for every family). The inputs are the two seeded images of
``tools/bench.py``, drawn once; per encoder the timed function returns
``depth.sum()``, two warm-up calls, then ``--iters`` 24 calls read back
``--delay`` 4 calls late. Prints, per encoder, the card's line and
``{"encoder", "img_per_s", "shape", "batch"}``. ``--profile_dir DIR`` traces
each encoder's timed loop into ``DIR/<encoder>/trace.json``. On the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from bts_tpu_torch.apps.predict import load_model
from bts_tpu_torch.cli.test import resolve_device
from bts_tpu_torch.config import Config
from bts_tpu_torch.tools import benchtools
from bts_tpu_torch.tools.bench import img_per_s, make_forward

ZOO = [
    "densenet121_bts",
    "densenet161_bts",
    "resnet50_bts",
    "resnet101_bts",
    "resnext50_bts",
    "resnext101_bts",
    "mobilenetv2_bts",
]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("encoders", nargs="*", default=None)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dataset", default="nyu")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--delay", type=int, default=4)
    ap.add_argument("--profile_dir", default="",
                    help="trace each encoder's timed calls into <dir>/<encoder>/trace.json")
    benchtools.device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    h, w, batch = args.height, args.width, args.batch
    images = benchtools.seeded_images(batch, h, w, device)
    focal = benchtools.focal(batch, device)
    records = []
    for enc in args.encoders or ZOO:
        cfg = Config(encoder=enc, dataset=args.dataset,
                     max_depth=10.0 if args.dataset == "nyu" else 80.0,
                     compute_dtype="bfloat16")
        model = load_model(cfg, device)
        profile_dir = os.path.join(args.profile_dir, enc) if args.profile_dir else ""
        rate = img_per_s(make_forward(model, cfg, device), images, focal, args.iters,
                         args.delay, device, profile_dir)
        records.append(benchtools.emit(device, {"encoder": enc, "img_per_s": round(rate, 1),
                                                "shape": f"{h}x{w}", "batch": batch}))
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
