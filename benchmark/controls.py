"""Upper readings of the correctness check: what the compared numbers read
when something other than a sound program stands in the program's place.

For each cell, on the cell's own inputs and sizes, against the float32
reference:

- ``control``: the reference with float8 convolutions and linear layers
  (``reference/lowp.py``), the precision below the configurations' bfloat16.

The benchmark's own runs never run these. On a card, for several seeds:

    python3 -m benchmark.controls --workload <cell> --seeds <n> <n> <n>

prints one JSON line a seed (``readings``: each stand-in's numbers).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import compare, spec
from benchmark.drivers import serve_closed
from benchmark.reference.lowp import fp8_round, set_quant
from benchmark.weights import reference_model


def serve_readings(config: dict, traffic: dict, seed: int, device: torch.device) -> dict:
    images = serve_closed.seeded_batches(config, traffic["batch"], traffic["pool"], seed, device)
    model = reference_model(config, seed, device).eval()

    def depth():  # every batch of the pool, which a run's kept calls are drawn from
        return np.stack([serve_closed.reference_depth(model, image, config["focal"], device)
                         for image in images])

    ref = depth()
    set_quant(model, fp8_round)
    return {"control": compare.depth_gaps(depth(), ref)}


READINGS = {"serve_closed": serve_readings}


def readings(workload: str, seed: int, device: torch.device) -> dict:
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    return READINGS[traffic["kind"]](config, traffic, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Upper readings of a cell's correctness check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    limits = spec.limits(args.workload)
    for seed in args.seeds:
        out = readings(args.workload, seed, torch.device(args.device))
        held = {k: compare.all_held(compare.held(v, limits)) for k, v in out.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": out,
                          "within_limits": held}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
