"""The full BTS model: DenseNet encoder + decoder.

Port of ``bts_tpu/models/bts.py``. Module names follow the reference
PyTorch model (``encoder.base_model.*``, ``decoder.*``), so reference
state dicts load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from bts_tpu_torch.models.decoder import BTSDecoder
from bts_tpu_torch.models.encoders import densenet

# name -> (factory, feat_out_channels). The ResNet, ResNeXt and MobileNet
# encoders of bts_tpu are ROADMAP.md queue 1, item 13.
ENCODERS = {
    "densenet121_bts": (densenet.densenet121, [64, 64, 128, 256, 1024]),
    "densenet161_bts": (densenet.densenet161, [96, 96, 192, 384, 2208]),
}


class BTSModel(nn.Module):
    """image (B,3,H,W) normalized, focal (B,) -> (lpg8x8, lpg4x4, lpg2x2,
    reduc1x1, depth_est), each (B,1,H,W) float32.

    The encoder's ``dense_impl`` (``encoders/densenet.py``) is ``auto``: an
    inference forward on a card runs the dense layers through the fused
    kernel."""

    def __init__(
        self,
        encoder_name: str = "densenet161_bts",
        max_depth: float = 10.0,
        dataset: str = "nyu",
        bts_size: int = 512,
        lpg_impl: str = "auto",
    ):
        super().__init__()
        factory, feat_out_channels = ENCODERS[encoder_name]
        self.encoder = factory()
        self.decoder = BTSDecoder(
            feat_out_channels, bts_size, max_depth, dataset, lpg_impl
        )

    def forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.decoder(self.encoder(x), focal)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init, as bts_tpu's: Xavier-uniform conv kernels (the port's
    convs have no bias), BN scale 1, bias 0, running mean 0, running var 1.
    Draws on the CPU generator."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            bound = math.sqrt(6.0 / ((i + o) * kh * kw))
            w = torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator)
            m.weight.copy_(w)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def check_encoder(name: str) -> None:
    """Raise unless ``name`` is an encoder the port has."""
    if name not in ENCODERS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported yet (ported: {sorted(ENCODERS)}): "
            "ROADMAP.md queue 1, item 13"
        )


def create_model(cfg) -> BTSModel:
    """Build a BTSModel from a Config on the CPU, its weights seeded from
    ``cfg.seed``."""
    check_encoder(cfg.encoder)
    if cfg.bts_size < 128:
        raise ValueError(
            f"bts_size must be >= 128 (got {cfg.bts_size}): the reduction_1x1 "
            "head needs bts_size//32 >= 4 channels"
        )
    model = BTSModel(
        encoder_name=cfg.encoder,
        max_depth=cfg.max_depth,
        dataset=cfg.dataset,
        bts_size=cfg.bts_size,
        lpg_impl=cfg.lpg_impl,
    )
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))
