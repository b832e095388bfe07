"""Serving throughput on the card: ``python -m bts_tpu_torch.tools.bench``.

The port's counterpart of the repo's ``bench.py``, doing its work and timing
it its way: DenseNet161-BTS, NYU, ``max_depth`` 10, seeded weights
(``cfg.seed``), 480x640, batch 128, bf16 autocast under ``inference_mode``,
the dense layers and the LPG at ``auto`` (the taps and LPG kernels), as
``cli.test`` runs them (``apps/predict.py``). The timed function returns
``depth.sum()`` as a device scalar; two warm-up calls on the two seeded
images, then 16 calls over them in turn, read back 3 calls late
(``benchtools.pipelined``). Prints the card's line, then
``{"metric": "nyu_densenet161_inference_480x640", "value", "unit": "img/s",
"vs_baseline"}``: ``vs_baseline`` divides by 19.2 img/s, the reference's TF
inference at batch 1 on one NVIDIA RTX 2080 Ti (``BASELINE.md``), not a
number of this card.

``--lpg-check``: batch 64, 8 calls at delay 2, for the default form (taps +
LPG kernel) and the plain one (``lpg_impl xla``, ``dense_impl plain``); one
img/s line each, then ``lpg_check_max_abs_diff_m``, the largest difference
of their depth maps, which must be under 0.15 m (bf16 noise on a 10 m range).

``--profile_dir DIR`` traces the timed loop into ``DIR/trace.json``.
``--height``, ``--width``, ``--batch``, ``--iters``, ``--delay`` and
``--encoder`` shrink the run (tests, with ``--device cpu``); without them
the tool does ``bench.py``'s work. On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bts_tpu_torch.apps.predict import compute_context, load_model
from bts_tpu_torch.cli.test import resolve_device
from bts_tpu_torch.config import Config
from bts_tpu_torch.tools import benchtools

REFERENCE_IMG_PER_SEC = 19.2  # the reference's TF inference, one RTX 2080 Ti (bench.py:20)
METRIC = "nyu_densenet161_inference_480x640"
LPG_CHECK_TOL_M = 0.15


def bench_config(encoder: str = "densenet161_bts", lpg_impl: str = "auto") -> Config:
    return Config(encoder=encoder, dataset="nyu", max_depth=10.0, compute_dtype="bfloat16",
                  lpg_impl=lpg_impl)


FORMS = {"default": "auto", "plain": "xla"}  # form -> lpg_impl


def load_form(form: str, encoder: str, device: torch.device):
    """(model, cfg) of ``form``, seeded alike: ``default`` (the taps and LPG
    kernels on a card) or ``plain`` (``lpg_impl xla``, ``dense_impl plain``)."""
    cfg = bench_config(encoder, FORMS[form])
    model = load_model(cfg, device)
    if form == "plain" and hasattr(getattr(model, "encoder", None), "dense_impl"):
        model.encoder.dense_impl = "plain"
    return model, cfg


def depth_map(model: torch.nn.Module, cfg: Config, image: torch.Tensor,
              focal: torch.Tensor, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(), compute_context(cfg, device):
        return model(image, focal)[-1]


def make_forward(model: torch.nn.Module, cfg: Config, device: torch.device):
    """(image, focal) -> the depth map's sum, a 0-d device tensor: the 4-byte
    readback of ``bench.py``'s ``forward``."""

    def forward(image: torch.Tensor, focal: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), compute_context(cfg, device):
            return model(image, focal)[-1].sum()

    return forward


def img_per_s(forward, images, focal, iters: int, delay: int, device: torch.device,
              profile_dir: str = "") -> float:
    """Two warm-up calls, then ``iters`` pipelined calls over ``images`` in turn."""
    for image in images[:2]:
        benchtools.read_back(forward(image, focal))
    with benchtools.profiled(profile_dir, device):
        seconds = benchtools.pipelined(lambda i: forward(images[i % len(images)], focal),
                                       iters, delay)
    return images[0].shape[0] * iters / seconds


def lpg_check(args, device: torch.device) -> list:
    """The default form against the plain one on one seeded batch."""
    batch = args.batch or 64
    (image,) = benchtools.seeded_images(batch, args.height, args.width, device, n=1)
    focal = benchtools.focal(batch, device)
    records, depth = [], {}
    for name in FORMS:
        model, cfg = load_form(name, args.encoder, device)
        depth[name] = depth_map(model, cfg, image, focal, device).float().cpu().numpy()
        rate = img_per_s(make_forward(model, cfg, device), [image], focal, args.iters or 8,
                         2 if args.delay is None else args.delay, device)
        records.append(benchtools.emit(device, {"metric": f"lpg_check_{name}",
                                                "value": round(rate, 2), "unit": "img/s"}))
        del model
    diff = float(np.abs(depth["default"] - depth["plain"]).max())
    records.append(benchtools.emit(device, {"metric": "lpg_check_max_abs_diff_m",
                                            "value": diff}))
    if not diff < LPG_CHECK_TOL_M:
        raise RuntimeError(f"the kernels and the plain path diverged: {diff} m")
    return records


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lpg-check", action="store_true",
                        help="the kernels against the plain path: img/s and max abs diff")
    parser.add_argument("--profile_dir", default="")
    parser.add_argument("--encoder", default="densenet161_bts")
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--batch", type=int, default=None, help="128 (--lpg-check: 64)")
    parser.add_argument("--iters", type=int, default=None, help="16 (--lpg-check: 8)")
    parser.add_argument("--delay", type=int, default=None, help="3 (--lpg-check: 2)")
    benchtools.device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.lpg_check:
        return lpg_check(args, device)

    batch = args.batch or 128
    model, cfg = load_form("default", args.encoder, device)
    images = benchtools.seeded_images(batch, args.height, args.width, device)
    rate = img_per_s(make_forward(model, cfg, device), images, benchtools.focal(batch, device),
                     args.iters or 16, 3 if args.delay is None else args.delay, device,
                     args.profile_dir)
    return [benchtools.emit(device, {
        "metric": METRIC, "value": round(rate, 2), "unit": "img/s",
        "vs_baseline": round(rate / REFERENCE_IMG_PER_SEC, 2)})]


if __name__ == "__main__":
    main(sys.argv[1:])
