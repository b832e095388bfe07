"""DenseNet-121/161 encoders (NCHW), with the five BTS skips.

Port of ``bts_tpu/models/encoders/densenet.py``, written by hand in
torchvision's layout and module names so that reference and torchvision
state dicts load as they are: ``base_model`` is torchvision's ``features``
(conv0 -> norm0 -> relu0 [skip] -> pool0 [skip] -> denseblock1 ->
transition1 [skip] -> denseblock2 -> transition2 [skip] -> denseblock3 ->
transition3 -> denseblock4 -> norm5 [skip, pre-ReLU]).

feat_out_channels: densenet121 [64, 64, 128, 256, 1024];
densenet161 [96, 96, 192, 384, 2208].
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch
from torch import nn

from bts_tpu_torch.models.layers import ENCODER_BN_EPS, TORCH_BN_MOMENTUM_ENCODER

SKIP_NAMES = ("relu0", "pool0", "transition1", "transition2", "norm5")


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=ENCODER_BN_EPS, momentum=TORCH_BN_MOMENTUM_ENCODER)


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 conv(4g) -> BN -> ReLU -> 3x3 conv(g)."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = _bn(in_features)
        self.relu1 = nn.ReLU()
        self.conv1 = nn.Conv2d(in_features, mid, 1, bias=False)
        self.norm2 = _bn(mid)
        self.relu2 = nn.ReLU()
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.relu1(self.norm1(x)))
        return self.conv2(self.relu2(self.norm2(y)))


class DenseBlock(nn.ModuleDict):
    """Each layer sees the concatenation of the block input and all new
    features so far; returns that concatenation."""

    def __init__(self, num_layers: int, in_features: int, growth_rate: int):
        super().__init__()
        for i in range(num_layers):
            self[f"denselayer{i + 1}"] = DenseLayer(in_features + i * growth_rate, growth_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.values():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class Transition(nn.Sequential):
    """BN -> ReLU -> 1x1 conv -> avgpool 2x2/2."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(
            OrderedDict(
                norm=_bn(in_features),
                relu=nn.ReLU(),
                conv=nn.Conv2d(in_features, out_features, 1, bias=False),
                pool=nn.AvgPool2d(2, stride=2),
            )
        )


class DenseNetEncoder(nn.Module):
    """Image (B,3,H,W) -> the 5 skips [H/2, H/4, H/8, H/16, H/32]."""

    def __init__(
        self,
        block_config: Sequence[int],
        growth_rate: int,
        num_init_features: int,
    ):
        super().__init__()
        mods = OrderedDict(
            conv0=nn.Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False),
            norm0=_bn(num_init_features),
            relu0=nn.ReLU(),
            pool0=nn.MaxPool2d(3, stride=2, padding=1),
        )
        c = num_init_features
        for i, num_layers in enumerate(block_config):
            mods[f"denseblock{i + 1}"] = DenseBlock(num_layers, c, growth_rate)
            c += num_layers * growth_rate
            if i != len(block_config) - 1:
                mods[f"transition{i + 1}"] = Transition(c, c // 2)
                c //= 2
        mods["norm5"] = _bn(c)
        self.base_model = nn.Sequential(mods)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in SKIP_NAMES:
                skips.append(x)
        return skips


def densenet121() -> DenseNetEncoder:
    return DenseNetEncoder((6, 12, 24, 16), 32, 64)


def densenet161() -> DenseNetEncoder:
    return DenseNetEncoder((6, 12, 36, 24), 48, 96)
