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
from bts_tpu_torch.models.graphed import GraphedForward
from bts_tpu_torch.models.layers import TF_BN_EPS
from bts_tpu_torch.models.remat import POLICIES, SCOPES, checkpointed, records_grad

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


class BTSModel(GraphedForward):
    """image (B,3,H,W) normalized, focal (B,) -> (lpg8x8, lpg4x4, lpg2x2,
    reduc1x1, depth_est), each (B,1,H,W) float32 (``OUTPUTS``).

    A DenseNet encoder's ``dense_impl`` (``encoders/densenet.py``) is
    ``auto``: an inference forward on a card runs the dense layers through
    the fused kernel. The ResNet, ResNeXt and MobileNetV2 encoders are cuDNN
    convs throughout; every encoder's forward reaches the LPG kernel at the
    decoder's three sites.

    ``flavor="tf"`` builds the reference's TF graph (tensorflow/bts.py), the
    graph of the TF zoo's checkpoints, for a DenseNet encoder only (the TF
    zoo's): encoder BN eps 1.1e-5 and slim's SAME stem, and the decoder's TF
    form (``decoder.py``).

    ``remat`` trades compute for memory in a forward that autograd records,
    as ``bts_tpu``'s: the encoder is a checkpoint region that saves only its
    convolutions' outputs (``remat_policy`` ``conv``) or nothing (``full``),
    and under ``remat_scope`` ``all`` the decoder is a second region that
    saves nothing (``models/remat.py``). Under no_grad or inference_mode it
    changes nothing.

    An inference forward on a card (eval mode, grad disabled) replays a CUDA
    graph of itself from the second call of an input signature on
    (``forward_graphs``, ``models/graphed.py``); ``train()``, ``.to()`` and
    ``load_state_dict`` drop the held graphs."""

    OUTPUTS = ("lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth")
    TRAINS = True

    def __init__(
        self,
        encoder_name: str = "densenet161_bts",
        max_depth: float = 10.0,
        dataset: str = "nyu",
        bts_size: int = 512,
        lpg_impl: str = "auto",
        flavor: str = "pt",
        remat: bool = False,
        remat_policy: str = "conv",
        remat_scope: str = "encoder",
    ):
        super().__init__()
        if remat_policy not in POLICIES or remat_scope not in SCOPES:
            raise ValueError(f"remat_policy must be one of {'/'.join(POLICIES)} and remat_scope "
                             f"one of {'/'.join(SCOPES)} (got {remat_policy!r}, "
                             f"{remat_scope!r})")
        self.remat, self.remat_policy, self.remat_scope = remat, remat_policy, remat_scope
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

    def _forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not (self.remat and records_grad(self)):
            return self.decoder(self.encoder(x), focal)
        skips = checkpointed(self.encoder, x, save_convolutions=self.remat_policy == "conv")
        if self.remat_scope == "all":
            return checkpointed(self.decoder, skips, focal)
        return self.decoder(skips, focal)


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


def create_model(cfg) -> BTSModel:
    """The BTSModel of ``cfg.encoder`` (an encoder of ``ENCODERS``) on the
    CPU, its weights seeded from ``cfg.seed``, in the graph of
    ``cfg.resolved_flavor``, rematerialising as ``cfg.remat``,
    ``remat_policy`` and ``remat_scope`` say. Callers build through the zoo,
    ``models.create_model``."""
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
        remat=cfg.remat,
        remat_policy=cfg.remat_policy,
        remat_scope=cfg.remat_scope,
    )
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))
