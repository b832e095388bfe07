"""ResNet-50/101 and ResNeXt-50/101 encoders (NCHW), with the five BTS skips.

Port of ``bts_tpu/models/encoders/resnet.py``, written by hand in
torchvision's layout and module names so that reference and torchvision
state dicts load as they are: ``base_model`` is torchvision's ResNet without
its head (conv1 -> bn1 -> relu [skip, H/2] -> maxpool -> layer1 [H/4] ->
layer2 [H/8] -> layer3 [H/16] -> layer4 [H/32]), each layer a run of
``Bottleneck`` blocks (``conv1/bn1/conv2/bn2/conv3/bn3``, and
``downsample.0``/``downsample.1`` on a layer's first block).

feat_out_channels: [64, 256, 512, 1024, 2048] for all four. ResNeXt's 3x3
convs are grouped (``nn.Conv2d(groups=32)``): resnext50 width 4 a group,
resnext101 width 8 (torchvision's 32x4d and 32x8d). ``bts_tpu`` runs them as
block-diagonal dense convs on the TPU (``_BlockDiagGroupedConv``), the same
math; that layout is not carried over.

The reference wraps torchvision's whole ResNet and skips its ``avgpool`` and
``fc`` in the forward (pytorch/bts.py:281-296,303-318), so a reference
checkpoint of this family carries ``encoder.base_model.fc.{weight,bias}``.
This encoder has no ``fc``: ``models/convert.py`` drops those keys when it
reads a checkpoint (``model_state``), as ``bts_tpu``'s converter, which
looks up only the keys its tree has, ignores them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch
from torch import nn

from bts_tpu_torch.models.layers import encoder_bn

SKIP_NAMES = ("relu", "layer1", "layer2", "layer3", "layer4")


class Bottleneck(nn.Module):
    """1x1 -> BN -> ReLU -> 3x3 (grouped, strided) -> BN -> ReLU -> 1x1(4p)
    -> BN, plus the identity (or ``downsample``), then ReLU."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = encoder_bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups,
                               bias=False)
        self.bn2 = encoder_bn(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = encoder_bn(out)
        self.relu = nn.ReLU()
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride=stride, bias=False), encoder_bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(y + identity)


class ResNetEncoder(nn.Module):
    """Image (B,3,H,W) -> the 5 skips [H/2, H/4, H/8, H/16, H/32]."""

    def __init__(self, layer_config: Sequence[int], groups: int = 1, base_width: int = 64):
        super().__init__()
        mods = OrderedDict(
            conv1=nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            bn1=encoder_bn(64),
            relu=nn.ReLU(),
            maxpool=nn.MaxPool2d(3, stride=2, padding=1),
        )
        c = 64
        for i, (blocks, planes) in enumerate(zip(layer_config, (64, 128, 256, 512))):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(c, planes, stride if b == 0 else 1, downsample=b == 0,
                                        groups=groups, base_width=base_width))
                c = planes * 4
            mods[f"layer{i + 1}"] = nn.Sequential(*layer)
        self.base_model = nn.Sequential(mods)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in SKIP_NAMES:
                skips.append(x)
        return skips


def resnet50() -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3))


def resnet101() -> ResNetEncoder:
    return ResNetEncoder((3, 4, 23, 3))


def resnext50() -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), groups=32, base_width=4)


def resnext101() -> ResNetEncoder:
    return ResNetEncoder((3, 4, 23, 3), groups=32, base_width=8)
