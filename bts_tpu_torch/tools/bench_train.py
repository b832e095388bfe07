"""Train-step throughput on the card: ``python -m bts_tpu_torch.tools.bench_train``.

The port's counterpart of ``scripts/bench_train.py``, with its flags and
defaults: DenseNet161-BTS, NYU (``--dataset kitti``: ``max_depth`` 80),
batch 16, 416x544 crops drawn by ``--device_augment`` (on unless
``--no_device_augment``) from raw 480x640 frames, bf16 autocast, AdamW
(``--bf16_moments``: its first moment in bf16). The step is ``cli.train``'s:
``create_optimizer`` (the reference's groups and set_misc freezing) and
``make_train_step`` (device augmentation, forward, silog, backward through
the LPG backward kernel, AdamW). Two host batches drawn from
``np.random.default_rng(0)`` as the script draws them, on the device; two
warm-up steps, then ``--steps`` 30 steps over them in turn, the loss read back
``--delay`` 3 steps late (``benchtools.pipelined``). Prints the card's line,
then ``{"metric": "train_step_<encoder>_<h>x<w>_b<batch>", "value", "unit":
"examples/s", "ms_per_step", "device_augment"}``. The script's
``vs_baseline`` divides by 106 ex/s measured on a TPU v5e chip; no number of
this card takes its place, so the line has none.

``--remat`` rematerialises as ``cli.train`` does (``models/remat.py``):
the encoder keeps only its convolutions' outputs (``--remat_policy conv``,
the default) or nothing (``full``), and ``--remat_scope all`` also
recomputes the decoder. ``--no_fast_tail`` names a TPU rewrite of
``bts_tpu`` that the port does not build: it parses and is ignored.
``--profile_dir DIR`` traces the timed steps into ``DIR/trace.json``. On the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from bts_tpu_torch.cli.test import resolve_device
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import create_model
from bts_tpu_torch.tools import benchtools
from bts_tpu_torch.training.optim import create_optimizer
from bts_tpu_torch.training.state import TrainState, make_train_step, to_device

IGNORED = "a TPU rewrite of bts_tpu; the port does not build it: ignored"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--encoder", default="densenet161_bts")
    ap.add_argument("--dataset", default="nyu", choices=["nyu", "kitti"])
    ap.add_argument("--height", type=int, default=416)
    ap.add_argument("--width", type=int, default=544)
    ap.add_argument("--bf16_moments", action="store_true",
                    help="store the Adam first moment (mu) in bfloat16")
    ap.add_argument("--raw_height", type=int, default=480)
    ap.add_argument("--raw_width", type=int, default=640)
    ap.add_argument("--no_device_augment", action="store_true")
    ap.add_argument("--no_fast_tail", action="store_true", help=IGNORED)
    ap.add_argument("--remat", action="store_true",
                    help="recompute activations in the backward to save memory")
    ap.add_argument("--remat_policy", default="conv", choices=["conv", "full"],
                    help="under --remat, save the encoder's conv outputs, or nothing")
    ap.add_argument("--remat_scope", default="encoder", choices=["encoder", "all"],
                    help="under --remat, recompute the encoder, or the decoder too")
    ap.add_argument("--profile_dir", default="")
    ap.add_argument("--delay", type=int, default=3,
                    help="readback delay in steps (pipeline depth)")
    benchtools.device_arg(ap)
    return ap.parse_args(argv)


def bench_config(args: argparse.Namespace) -> Config:
    """The script's Config, field for field (``scripts/bench_train.py:71-84``)."""
    return Config(
        encoder=args.encoder,
        dataset=args.dataset,
        max_depth=10.0 if args.dataset == "nyu" else 80.0,
        adam_bf16_moments=args.bf16_moments,
        compute_dtype="bfloat16",
        batch_size=args.batch,
        input_height=args.height,
        input_width=args.width,
        device_augment=not args.no_device_augment,
        fast_tail=not args.no_fast_tail,
        remat=args.remat,
        remat_policy=args.remat_policy,
        remat_scope=args.remat_scope,
    )


def host_batches(args: argparse.Namespace) -> list:
    """The script's two host batches (NHWC numpy), drawn in its order."""
    rng = np.random.default_rng(0)
    src_h, src_w = ((args.raw_height, args.raw_width) if not args.no_device_augment
                    else (args.height, args.width))
    return [{
        "image": rng.random((args.batch, src_h, src_w, 3), np.float32),
        "depth": rng.random((args.batch, src_h, src_w, 1), np.float32) * 9.9 + 0.1,
        "focal": np.full((args.batch,), benchtools.FOCAL, np.float32),
    } for _ in range(2)]


def main(argv=None) -> list:
    args = parse(argv)
    device = resolve_device(args.device)
    cfg = bench_config(args)
    model = create_model(cfg).to(device)
    optimizer, _ = create_optimizer(cfg, model, num_total_steps=10_000)
    state = TrainState(model, optimizer)
    train_step = make_train_step(cfg)
    batches = [to_device(b, device) for b in host_batches(args)]

    for b in batches:  # warm-up
        benchtools.read_back(train_step(state, b))
    with benchtools.profiled(args.profile_dir, device):
        seconds = benchtools.pipelined(lambda i: train_step(state, batches[i % 2]),
                                       args.steps, args.delay)
    ex_per_sec = args.batch * args.steps / seconds
    return [benchtools.emit(device, {
        "metric": f"train_step_{args.encoder}_{args.height}x{args.width}_b{args.batch}",
        "value": round(ex_per_sec, 2),
        "unit": "examples/s",
        "ms_per_step": round(seconds / args.steps * 1000, 2),
        "device_augment": cfg.device_augment,
    })]


if __name__ == "__main__":
    main(sys.argv[1:])
