"""Seeded weights for both sides, made on the device, for any model's plain
reference (``spec.model(config).reference(config)``), whose state dict's
names the program's model shares. The reference's parameters and running
statistics are drawn from the seed, in float32, the dtype the program keeps
its weights in. Whether a tensor is learned is read from the reference
itself (its parameters against its buffers), and its kind then from its
name and shape:

- a parameter ``*.weight`` of 2 or more dimensions: Xavier-uniform (fan in
  ``size(1)``, fan out ``size(0)``, each times the receptive field), cut
  from one flat ``torch.rand`` draw in state-dict order;
- a 1-D parameter ``*.weight`` and ``running_var``: ones; a parameter
  ``*.bias`` and ``running_mean``: zeros; ``num_batches_tracked``: 0;
- any other parameter (position-bias tables, tokens, layer scales): a
  normal of std 0.02 truncated at -2 and 2 (torch's and timm's bounds), as
  Swin and ViT initialise them, cut from one flat draw of a second
  generator, so the first draw stays as it is;
- any other buffer, floating or integer (index tables, masks, fixed
  position tables), is computed, not learned: it is not in the seeded state
  dict, and each side computes its own, as its code does.

For BTS that is the published run's init before its ImageNet weights load:
Xavier-uniform convolutions, batch norms at identity.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import spec

# The second generator's seed is the run's seed with these bits flipped.
SECOND_STREAM = 0x7AB1E
RUNNING = {"running_mean": "zero", "running_var": "one", "num_batches_tracked": "zero"}


def _kinds(model: torch.nn.Module) -> Dict[str, str]:
    """The kind of each seeded tensor of ``model``, in state-dict order."""
    params = {k for k, _ in model.named_parameters(remove_duplicate=False)}
    kinds = {}
    for k, t in model.state_dict().items():
        if k in params:
            if k.endswith(".weight"):
                kinds[k] = "xavier" if t.dim() >= 2 else "one"
            else:
                kinds[k] = "zero" if k.endswith(".bias") else "normal"
        elif k.rpartition(".")[2] in RUNNING:  # a running statistic
            kinds[k] = RUNNING[k.rpartition(".")[2]]
    return kinds


def seeded_state_dict(config: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The reference's parameters and running statistics drawn from ``seed``;
    the buffers it computes are left out."""
    with torch.device("meta"):
        model = spec.model(config).reference(config)
    shapes, kinds = model.state_dict(), _kinds(model)
    flats = {}
    for kind, stream in (("xavier", seed), ("normal", seed ^ SECOND_STREAM)):
        n = sum(shapes[k].numel() for k, v in kinds.items() if v == kind)
        if n:
            gen = torch.Generator(device=device)
            gen.manual_seed(stream)
            flats[kind] = (torch.rand(n, generator=gen, device=device) if kind == "xavier" else
                           torch.nn.init.trunc_normal_(torch.empty(n, device=device), std=0.02,
                                                       generator=gen))
    offsets = dict.fromkeys(flats, 0)
    out = {}
    for k, kind in kinds.items():
        v = shapes[k]
        if kind in flats:
            n = v.numel()
            piece = flats[kind][offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            if kind == "xavier":
                field = math.prod(v.shape[2:])
                bound = math.sqrt(6.0 / ((v.shape[0] + v.shape[1]) * field))
                piece = piece * (2 * bound) - bound
            out[k] = piece.view(v.shape)
        else:
            out[k] = (torch.ones if kind == "one" else torch.zeros)(v.shape, dtype=v.dtype,
                                                                  device=device)
    return out


def reference_model(config: dict, seed: int, device: torch.device) -> torch.nn.Module:
    """The plain reference in float32, built on ``device`` with the seed's
    weights; the buffers it computes are its own code's."""
    with torch.device(device):
        model = spec.model(config).reference(config)
    # Not strict: the computed buffers are absent from the seeded state dict.
    model.load_state_dict(seeded_state_dict(config, seed, device), strict=False, assign=True)
    return model
