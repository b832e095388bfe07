"""Work counted from shapes, never from how the program computes it.

- ``forward_flops``: ``FlopCounterMode`` over the plain reference on the
  meta device at a cell's shapes (convolutions and matrix products; the
  LPG's and the normalizations' elementwise work is not counted).
- ``dense_layer_work``: the operations and bytes of DenseNet's dense layers
  (BN-ReLU-1x1 conv-BN-ReLU-3x3 conv) at a batch and an input size, from the
  published widths alone: operations 2*B*H*W*(C_in*Cmid + Cmid*G*9) a layer;
  bytes its input, output, weights and batch-norm vectors, each once.
- ``peak``: the card's published peaks (``peaks.json``).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import BTS

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _meta_model(config: dict) -> BTS:
    with torch.device("meta"):
        return BTS(config)


@functools.lru_cache(maxsize=None)
def _forward_flops(key: str, batch: int, h: int, w: int) -> int:
    config = json.loads(key)
    model = _meta_model(config).eval()
    x = torch.empty(batch, 3, h, w, device="meta")
    focal = torch.empty(batch, device="meta")
    with torch.no_grad():
        return _count(lambda: model(x, focal))


def forward_flops(config: dict, batch: int, h: int, w: int) -> int:
    return _forward_flops(json.dumps(config, sort_keys=True), batch, h, w)


def dense_layer_shapes(config: dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    """(C_in, H, W) of every dense layer of one forward at input h x w."""
    arch = config["encoder_arch"]
    g, c = arch["growth_rate"], arch["num_init_features"]
    fh, fw = -(-h // 4), -(-w // 4)  # after the stride-2 stem and pool
    out = []
    for i, n in enumerate(arch["block_config"]):
        out += [(c + j * g, fh, fw) for j in range(n)]
        c += n * g
        if i != len(arch["block_config"]) - 1:
            c, fh, fw = c // 2, fh // 2, fw // 2
    return out


def dense_layer_work(config: dict, batch: int, h: int, w: int, elem_bytes: int
                     ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each dense layer of one forward."""
    arch = config["encoder_arch"]
    g = arch["growth_rate"]
    mid = arch["bn_size"] * g
    out = []
    for c, fh, fw in dense_layer_shapes(config, h, w):
        px = batch * fh * fw
        ops = 2.0 * px * (c * mid + mid * g * 9)
        nbytes = elem_bytes * (px * (c + g) + c * mid + mid * g * 9 + 2 * c + 2 * mid)
        out.append((ops, nbytes))
    return out


def peak(kind: str) -> dict:
    with open(PEAKS) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return table[kind]
