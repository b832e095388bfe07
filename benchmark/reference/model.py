"""Plain BTS: the benchmark's reference model, in plain PyTorch ops.

A frozen copy of the published architecture (cleinc/bts ``pytorch/bts.py``
with torchvision's DenseNet and ResNeXt): encoder, U-Net decoder with
Dense-ASPP, and Local Planar Guidance written as its formula. It imports
nothing of the measured program, runs in whatever dtype its weights and
input have (the harness runs it in float32 with TF32 off), and uses the
module names of the published model, so one state dict loads into it and
into the program alike.

Every ``Conv2d`` here is ``Conv``, whose ``quant`` (None by default) may be
set to a function that both its input and its weight pass through: the
lower-precision control (``reference/lowp.py``) sets it.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DECODER_BN_MOMENTUM = 0.01
DECODER_BN_EPS = 1.1e-5
ENCODER_BN_EPS = 1e-5
# The inputs' normalization (torchvision's ImageNet statistics).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight pass through ``quant`` when set."""

    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        return self._conv_forward(self.quant(x), self.quant(self.weight), self.bias)


def encoder_bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=ENCODER_BN_EPS, momentum=0.1)


def decoder_bn(c: int, eps: float = DECODER_BN_EPS) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps, momentum=DECODER_BN_MOMENTUM)


# ---------------------------------------------------------------- encoders

class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int, bn_size: int):
        super().__init__()
        mid = bn_size * growth
        self.norm1 = encoder_bn(cin)
        self.conv1 = Conv(cin, mid, 1, bias=False)
        self.norm2 = encoder_bn(mid)
        self.conv2 = Conv(mid, growth, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(y)))


class DenseBlock(nn.ModuleDict):
    def __init__(self, layers: int, cin: int, growth: int, bn_size: int):
        super().__init__()
        for i in range(layers):
            self[f"denselayer{i + 1}"] = DenseLayer(cin + i * growth, growth, bn_size)

    def forward(self, x):
        for layer in self.values():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class DenseNet(nn.Module):
    """torchvision's ``features``; skips after relu0, pool0, transition1,
    transition2 and norm5 (pre-ReLU)."""

    SKIPS = ("relu0", "pool0", "transition1", "transition2", "norm5")

    def __init__(self, blocks: Sequence[int], growth: int, init_features: int, bn_size: int):
        super().__init__()
        mods = OrderedDict(
            conv0=Conv(3, init_features, 7, stride=2, padding=3, bias=False),
            norm0=encoder_bn(init_features),
            relu0=nn.ReLU(),
            pool0=nn.MaxPool2d(3, stride=2, padding=1),
        )
        c = init_features
        for i, n in enumerate(blocks):
            mods[f"denseblock{i + 1}"] = DenseBlock(n, c, growth, bn_size)
            c += n * growth
            if i != len(blocks) - 1:
                mods[f"transition{i + 1}"] = nn.Sequential(OrderedDict(
                    norm=encoder_bn(c), relu=nn.ReLU(), conv=Conv(c, c // 2, 1, bias=False),
                    pool=nn.AvgPool2d(2, stride=2)))
                c //= 2
        mods["norm5"] = encoder_bn(c)
        self.base_model = nn.Sequential(mods)

    def forward(self, x) -> List[torch.Tensor]:
        skips = []
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in self.SKIPS:
                skips.append(x)
        return skips


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool, groups: int,
                 base_width: int):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = Conv(cin, width, 1, bias=False)
        self.bn1 = encoder_bn(width)
        self.conv2 = Conv(width, width, 3, stride=stride, padding=1, groups=groups, bias=False)
        self.bn2 = encoder_bn(width)
        self.conv3 = Conv(width, out, 1, bias=False)
        self.bn3 = encoder_bn(out)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride=stride, bias=False),
                                         encoder_bn(out)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """torchvision's ResNet/ResNeXt without its head; skips after relu and
    each of layer1-4."""

    SKIPS = ("relu", "layer1", "layer2", "layer3", "layer4")

    def __init__(self, layers: Sequence[int], groups: int, base_width: int):
        super().__init__()
        mods = OrderedDict(
            conv1=Conv(3, 64, 7, stride=2, padding=3, bias=False),
            bn1=encoder_bn(64),
            relu=nn.ReLU(),
            maxpool=nn.MaxPool2d(3, stride=2, padding=1),
        )
        c = 64
        for i, (n, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(c, planes, (1 if i == 0 else 2) if b == 0 else 1,
                                         b == 0, groups, base_width))
                c = planes * 4
            mods[f"layer{i + 1}"] = nn.Sequential(*blocks)
        self.base_model = nn.Sequential(mods)

    def forward(self, x) -> List[torch.Tensor]:
        skips = []
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in self.SKIPS:
                skips.append(x)
        return skips


def build_encoder(arch: dict):
    """(encoder, the five skips' channels) from a configuration's ``encoder_arch``."""
    if arch["family"] == "densenet":
        enc = DenseNet(arch["block_config"], arch["growth_rate"], arch["num_init_features"],
                       arch["bn_size"])
        c = arch["num_init_features"]
        chans = [c, c]
        for i, n in enumerate(arch["block_config"]):
            c += n * arch["growth_rate"]
            if i != len(arch["block_config"]) - 1:
                c //= 2
                if i < 2:
                    chans.append(c)
        return enc, chans + [c]
    if arch["family"] == "resnet":
        enc = ResNet(arch["layers"], arch["groups"], arch["width_per_group"])
        return enc, [64, 256, 512, 1024, 2048]
    raise ValueError(f"unknown encoder family {arch['family']!r}")


# ----------------------------------------------------------------- decoder

def upsample(x, k: int):
    return x.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)


class UpConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 3, padding=1, bias=False)

    def forward(self, x):
        return F.elu(self.conv(upsample(x, 2)))


def conv_elu(cin, cout):
    return nn.Sequential(Conv(cin, cout, 3, padding=1, bias=False), nn.ELU())


class AtrousConv(nn.Module):
    def __init__(self, cin, cout, dilation, apply_bn_first=True):
        super().__init__()
        self.atrous_conv = nn.Sequential()
        if apply_bn_first:
            self.atrous_conv.add_module("first_bn", decoder_bn(cin))
        self.atrous_conv.add_module("aconv_sequence", nn.Sequential(
            nn.ReLU(),
            Conv(cin, cout * 2, 1, bias=False),
            decoder_bn(cout * 2, eps=1e-5),
            nn.ReLU(),
            Conv(cout * 2, cout, 3, padding=dilation, dilation=dilation, bias=False)))

    def forward(self, x):
        return self.atrous_conv(x)


class Reduction1x1(nn.Module):
    def __init__(self, num_in, num_out, max_depth, is_final=False):
        super().__init__()
        self.max_depth, self.is_final = max_depth, is_final
        self.reduc = nn.Sequential()
        while num_out >= 4:
            if num_out < 8:
                if is_final:
                    self.reduc.add_module("final", nn.Sequential(Conv(num_in, 1, 1, bias=False),
                                                                 nn.Sigmoid()))
                else:
                    self.reduc.add_module("plane_params", Conv(num_in, 3, 1, bias=False))
                break
            self.reduc.add_module(f"inter_{num_in}_{num_out}",
                                  nn.Sequential(Conv(num_in, num_out, 1, bias=False), nn.ELU()))
            num_in, num_out = num_out, num_out // 2

    def forward(self, x):
        x = self.reduc(x)
        if self.is_final:
            return x
        theta = torch.sigmoid(x[:, 0]) * (math.pi / 3)
        phi = torch.sigmoid(x[:, 1]) * (2 * math.pi)
        dist = torch.sigmoid(x[:, 2]) * self.max_depth
        n1 = torch.sin(theta) * torch.cos(phi)
        n2 = torch.sin(theta) * torch.sin(phi)
        n3 = torch.cos(theta)
        return torch.stack([n1, n2, n3, dist], dim=1)  # (B, 4, H, W)


def local_planar_guidance(plane: torch.Tensor, r: int) -> torch.Tensor:
    """(B, 4, h, w) plane equations -> (B, 1, h*r, w*r): the depth at each
    pixel of a cell on that cell's plane, n4 / (n1 u + n2 v + n3), with
    u, v the pixel's offset from the cell's centre in cells, and the normal
    (n1, n2, n3) scaled to unit length first."""
    normal = plane[:, :3] / torch.linalg.vector_norm(plane[:, :3], dim=1, keepdim=True)
    n1, n2, n3 = (upsample(normal[:, i:i + 1], r) for i in range(3))
    n4 = upsample(plane[:, 3:4], r)
    h, w = n1.shape[-2:]
    offs = lambda n: ((torch.arange(n, device=plane.device, dtype=plane.dtype) % r)
                      - (r - 1) / 2.0) / r
    u = offs(w).view(1, 1, 1, w)
    v = offs(h).view(1, 1, h, 1)
    return n4 / (n1 * u + n2 * v + n3)


class Decoder(nn.Module):
    def __init__(self, fc: Sequence[int], nf: int, max_depth: float, dataset: str):
        super().__init__()
        self.max_depth, self.dataset = max_depth, dataset
        self.upconv5 = UpConv(fc[4], nf)
        self.bn5 = decoder_bn(nf)
        self.conv5 = conv_elu(nf + fc[3], nf)
        self.upconv4 = UpConv(nf, nf // 2)
        self.bn4 = decoder_bn(nf // 2)
        self.conv4 = conv_elu(nf // 2 + fc[2], nf // 2)
        self.bn4_2 = decoder_bn(nf // 2)
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False)
        self.daspp_6 = AtrousConv(nf // 2 + nf // 4 + fc[2], nf // 4, 6)
        self.daspp_12 = AtrousConv(nf + fc[2], nf // 4, 12)
        self.daspp_18 = AtrousConv(nf + nf // 4 + fc[2], nf // 4, 18)
        self.daspp_24 = AtrousConv(nf + nf // 2 + fc[2], nf // 4, 24)
        self.daspp_conv = conv_elu(nf + nf // 2 + nf // 4, nf // 4)
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth)
        self.upconv3 = UpConv(nf // 4, nf // 4)
        self.bn3 = decoder_bn(nf // 4)
        self.conv3 = conv_elu(nf // 4 + fc[1] + 1, nf // 4)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth)
        self.upconv2 = UpConv(nf // 4, nf // 8)
        self.bn2 = decoder_bn(nf // 8)
        self.conv2 = conv_elu(nf // 8 + fc[0] + 1, nf // 8)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth)
        self.upconv1 = UpConv(nf // 8, nf // 16)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth, is_final=True)
        self.conv1 = conv_elu(nf // 16 + 4, nf // 16)
        self.get_depth = nn.Sequential(Conv(nf // 16, 1, 3, padding=1, bias=False), nn.Sigmoid())

    def forward(self, skips, focal):
        skip0, skip1, skip2, skip3 = skips[:4]
        dense = F.relu(skips[4])
        upconv5 = self.bn5(self.upconv5(dense))
        iconv5 = self.conv5(torch.cat([upconv5, skip3], 1))
        upconv4 = self.bn4(self.upconv4(iconv5))
        concat4 = torch.cat([upconv4, skip2], 1)
        iconv4 = self.bn4_2(self.conv4(concat4))
        daspp_3 = self.daspp_3(iconv4)
        concat4_2 = torch.cat([concat4, daspp_3], 1)
        daspp_6 = self.daspp_6(concat4_2)
        concat4_3 = torch.cat([concat4_2, daspp_6], 1)
        daspp_12 = self.daspp_12(concat4_3)
        concat4_4 = torch.cat([concat4_3, daspp_12], 1)
        daspp_18 = self.daspp_18(concat4_4)
        concat4_5 = torch.cat([concat4_4, daspp_18], 1)
        daspp_24 = self.daspp_24(concat4_5)
        daspp_feat = self.daspp_conv(torch.cat(
            [iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], 1))

        lpg8 = local_planar_guidance(self.reduc8x8(daspp_feat), 8) / self.max_depth
        upconv3 = self.bn3(self.upconv3(daspp_feat))
        iconv3 = self.conv3(torch.cat([upconv3, skip1, lpg8[..., ::4, ::4]], 1))
        lpg4 = local_planar_guidance(self.reduc4x4(iconv3), 4) / self.max_depth
        upconv2 = self.bn2(self.upconv2(iconv3))
        iconv2 = self.conv2(torch.cat([upconv2, skip0, lpg4[..., ::2, ::2]], 1))
        lpg2 = local_planar_guidance(self.reduc2x2(iconv2), 2) / self.max_depth
        upconv1 = self.upconv1(iconv2)
        reduc1 = self.reduc1x1(upconv1)
        iconv1 = self.conv1(torch.cat([upconv1, reduc1, lpg2, lpg4, lpg8], 1))
        depth = self.max_depth * self.get_depth(iconv1)
        if self.dataset == "kitti":
            depth = depth * focal.view(-1, 1, 1, 1) / 715.0873
        return depth


class BTS(nn.Module):
    """image (B, 3, H, W) normalized, focal (B,) -> depth (B, 1, H, W)."""

    def __init__(self, config: dict):
        super().__init__()
        self.encoder, chans = build_encoder(config["encoder_arch"])
        self.decoder = Decoder(chans, config["bts_size"], config["max_depth"], config["dataset"])

    def forward(self, image, focal):
        return self.decoder(self.encoder(image), focal)


def no_tf32():
    """Keep float32 convolutions and matmuls in float32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
