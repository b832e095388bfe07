"""Seeded weights for both sides, made on the device.

The init of the published training run before its ImageNet weights load
(Xavier-uniform convolutions; batch norms with scale 1, shift 0, running
mean 0 and variance 1), drawn from one ``torch.Generator`` on ``device`` in
one call, in float32, the dtype the program keeps its weights in. The state
dict's names are the published model's, which the program's modules and the
reference's share.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import BTS


def seeded_state_dict(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = BTS(config).state_dict()
    convs = [k for k, v in shapes.items() if v.dim() == 4]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(shapes[k].numel() for k in convs), generator=gen, device=device)
    out, offset = {}, 0
    for k, v in shapes.items():
        if v.dim() == 4:
            o, i, kh, kw = v.shape
            bound = math.sqrt(6.0 / ((i + o) * kh * kw))
            n = v.numel()
            out[k] = (flat[offset:offset + n] * (2 * bound) - bound).view(v.shape)
            offset += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(("running_var", ".weight")):
            out[k] = torch.ones(v.shape, device=device)
        else:  # running_mean, .bias
            out[k] = torch.zeros(v.shape, device=device)
    return out


def reference_model(config: dict, seed: int, device: torch.device) -> BTS:
    """The plain reference in float32 on ``device``, with the seed's weights."""
    with torch.device("meta"):
        model = BTS(config)
    model.load_state_dict(seeded_state_dict(config, seed, device), assign=True)
    return model
