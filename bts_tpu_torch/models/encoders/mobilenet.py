"""MobileNetV2 encoder (NCHW), with the five BTS skips.

Port of ``bts_tpu/models/encoders/mobilenet.py``, written by hand in
torchvision's layout and module names so that reference and torchvision
state dicts load as they are: ``base_model`` is torchvision's
``mobilenet_v2().features`` (pytorch/bts.py:297-301):

  * ``0``: ConvBNReLU6(32, stride 2), children ``0.0`` (conv) and ``0.1`` (BN);
  * ``1`` ... ``17``: InvertedResiduals, each a ``conv`` Sequential:
    ``conv.0`` ConvBNReLU6 depthwise, ``conv.1`` project conv, ``conv.2`` BN
    for ``1`` (expand ratio 1); ``conv.0`` ConvBNReLU6 expand 1x1,
    ``conv.1`` ConvBNReLU6 depthwise, ``conv.2`` project conv, ``conv.3`` BN
    for the others;
  * ``18``: ConvBNReLU6(1280, 1x1).

The skips come after the modules at 0-based indices 1, 3, 6, 10 and 18
(1-based 2, 4, 7, 11, 19 in pytorch/bts.py:313-315). feat_out_channels:
[16, 24, 32, 64, 1280]. ReLU6 is ``nn.ReLU6``: min(max(x, 0), 6). The
depthwise convs are ``nn.Conv2d(groups=channels)``; ``bts_tpu``'s
shifted-FMA form of them (``_ShiftDepthwiseConv``, a TPU layout of the same
math) is not carried over.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from bts_tpu_torch.models.layers import encoder_bn

# (expand_ratio, out_channels, num_blocks, first_stride)
INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
SKIP_AFTER = (1, 3, 6, 10, 18)


def conv_bn_relu6(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                  groups: int = 1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, groups=groups,
                  bias=False),
        encoder_bn(cout),
        nn.ReLU6(),
    )


class InvertedResidual(nn.Module):
    """[1x1 expand] -> 3x3 depthwise (strided) -> 1x1 project -> BN, plus
    the input where the stride is 1 and the widths agree."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = [conv_bn_relu6(cin, hidden, 1)] if expand_ratio != 1 else []
        layers += [
            conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
            nn.Conv2d(hidden, cout, 1, bias=False),
            encoder_bn(cout),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2Encoder(nn.Module):
    """Image (B,3,H,W) -> the 5 skips [H/2, H/4, H/8, H/16, H/32]."""

    def __init__(self):
        super().__init__()
        features = [conv_bn_relu6(3, 32, 3, 2)]
        c = 32
        for t, cout, n, s in INVERTED_RESIDUAL_CFG:
            for b in range(n):
                features.append(InvertedResidual(c, cout, s if b == 0 else 1, t))
                c = cout
        features.append(conv_bn_relu6(c, 1280, 1))
        self.base_model = nn.Sequential(*features)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for i, module in enumerate(self.base_model):
            x = module(x)
            if i in SKIP_AFTER:
                skips.append(x)
        return skips


def mobilenetv2() -> MobileNetV2Encoder:
    return MobileNetV2Encoder()
