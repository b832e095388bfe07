"""The full BTS model: encoder zoo + decoder.

Port of ``bts_tpu/models/bts.py``. Module names follow the reference
PyTorch model (``encoder.base_model.*``, ``decoder.*``), so reference
state dicts load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import inspect
import math
from typing import Tuple

import torch
from torch import nn

from bts_tpu_torch.models.decoder import BTSDecoder
from bts_tpu_torch.models.encoders import densenet, mobilenet, resnet
from bts_tpu_torch.models.layers import TF_BN_EPS

# name -> (factory, feat_out_channels), as bts_tpu's (pytorch/bts.py:273-301).
ENCODERS = {
    "densenet121_bts": (densenet.densenet121, [64, 64, 128, 256, 1024]),
    "densenet161_bts": (densenet.densenet161, [96, 96, 192, 384, 2208]),
    "resnet50_bts": (resnet.resnet50, [64, 256, 512, 1024, 2048]),
    "resnet101_bts": (resnet.resnet101, [64, 256, 512, 1024, 2048]),
    "resnext50_bts": (resnet.resnext50, [64, 256, 512, 1024, 2048]),
    "resnext101_bts": (resnet.resnext101, [64, 256, 512, 1024, 2048]),
    "mobilenetv2_bts": (mobilenet.mobilenetv2, [16, 24, 32, 64, 1280]),
}


class BTSModel(nn.Module):
    """image (B,3,H,W) normalized, focal (B,) -> (lpg8x8, lpg4x4, lpg2x2,
    reduc1x1, depth_est), each (B,1,H,W) float32.

    A DenseNet encoder's ``dense_impl`` (``encoders/densenet.py``) is
    ``auto``: an inference forward on a card runs the dense layers through
    the fused kernel. The ResNet, ResNeXt and MobileNetV2 encoders are cuDNN
    convs throughout; every encoder's forward reaches the LPG kernel at the
    decoder's three sites.

    ``flavor="tf"`` builds the reference's TF graph (tensorflow/bts.py), the
    graph of the TF zoo's checkpoints, for a DenseNet encoder only (the TF
    zoo's): encoder BN eps 1.1e-5 and slim's SAME stem, and the decoder's TF
    form (``decoder.py``)."""

    def __init__(
        self,
        encoder_name: str = "densenet161_bts",
        max_depth: float = 10.0,
        dataset: str = "nyu",
        bts_size: int = 512,
        lpg_impl: str = "auto",
        flavor: str = "pt",
    ):
        super().__init__()
        factory, feat_out_channels = ENCODERS[encoder_name]
        kw = {}
        if flavor == "tf":
            if "bn_eps" not in inspect.signature(factory).parameters:
                raise ValueError(
                    f"flavor 'tf' takes a densenet encoder only (got {encoder_name!r}): the "
                    "reference's TF zoo ships densenet121/161 (tensorflow/bts.py:398-430)"
                )
            kw = {"bn_eps": TF_BN_EPS, "tf_stem": True}
        self.encoder = factory(**kw)
        self.decoder = BTSDecoder(
            feat_out_channels, bts_size, max_depth, dataset, lpg_impl, flavor
        )

    def forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.decoder(self.encoder(x), focal)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init, as bts_tpu's: Xavier-uniform conv kernels, conv biases
    (the TF graph's) 0, BN scale 1, bias 0, running mean 0, running var 1.
    Draws on the CPU generator. A grouped conv's fans count its in-channels
    per group (``weight.shape[1]``), as flax's over its grouped kernel."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            bound = math.sqrt(6.0 / ((i + o) * kh * kw))
            w = torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def check_encoder(name: str) -> None:
    """Raise unless ``name`` is an encoder of the zoo."""
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; options: {sorted(ENCODERS)}")


def create_model(cfg) -> BTSModel:
    """Build a BTSModel from a Config on the CPU, its weights seeded from
    ``cfg.seed``, in the graph of ``cfg.resolved_flavor``."""
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
        flavor=cfg.resolved_flavor,
    )
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))
