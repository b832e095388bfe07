"""BTS decoder: U-Net with Dense-ASPP and multi-scale Local Planar Guidance.

Port of ``bts_tpu/models/decoder.py`` (plain tail), NCHW. Module names are
the reference PyTorch decoder's, which ``bts_tpu``'s converter maps, so
reference state dicts load as they are. ``bts_tpu``'s TPU layout rewrites
(fused lhs-dilated upconv, SplitConv, the space-to-depth tail) are exact math
against this plain graph and are not carried over.

``flavor="tf"`` is the reference's TF graph (tensorflow/bts.py:237-345), the
graph of the TF zoo's checkpoints: every conv carries a bias, theta_max is
pi/6, the atrous convs pad their input before the first BN and add an ELU
after the 1x1 conv (``AtrousConv``), the final reduction starts at nf//16
(one more conv), and the guidance maps are downsampled on the align-corners
grid. Its modules keep the PT graph's names, so ``bts_tpu``'s TF-flavor trees
load through ``convert.state_dict_from_flax``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import (
    DECODER_BN_EPS,
    decoder_bn,
    downsample_nearest,
    downsample_nearest_ac,
    upsample_nearest,
)
from bts_tpu_torch.ops.lpg import decode_plane_eq, local_planar_guidance, normalize_plane


FLAVORS = ("pt", "tf")


def _conv_elu(cin: int, cout: int, bias: bool = False) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=bias), nn.ELU())


class UpConv(nn.Module):
    """Nearest upsample x ratio -> 3x3 conv -> ELU. For an exact 2x, TF's
    align-corners upsample is this repeat too (``bts_tpu``'s tests show it)."""

    def __init__(self, cin: int, cout: int, ratio: int = 2, bias: bool = False):
        super().__init__()
        self.ratio = ratio
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(upsample_nearest(x, self.ratio)))


class AtrousConv(nn.Module):
    """(optional BN) -> ReLU -> 1x1 conv(2C) -> BN -> ReLU -> 3x3 dilated conv.

    First BN eps 1.1e-5, the inner BN torch's default 1e-5 (momentum 0.01).

    ``tf_variant`` (tensorflow/bts.py:84-100): both convs carry biases, an
    ELU follows the 1x1 conv, the inner BN takes eps 1.1e-5, and the input
    is zero-padded by ``dilation`` before the first BN (also where there is
    none), so the pad band flows through BN, ReLU, the 1x1 conv, the ELU and
    the inner BN and reaches the dilated conv nonzero; that conv is VALID.
    Padding inside the conv, as the PT graph does, differs at the borders.
    """

    def __init__(self, cin: int, cout: int, dilation: int, apply_bn_first: bool = True,
                 tf_variant: bool = False):
        super().__init__()
        self.dilation = dilation
        self.tf_variant = tf_variant
        self.atrous_conv = nn.Sequential()
        if apply_bn_first:
            self.atrous_conv.add_module("first_bn", decoder_bn(cin))
        self.atrous_conv.add_module(
            "aconv_sequence",
            nn.Sequential(
                nn.ReLU(),
                nn.Conv2d(cin, cout * 2, 1, bias=tf_variant),
                decoder_bn(cout * 2, eps=DECODER_BN_EPS if tf_variant else 1e-5),
                nn.ReLU(),
                nn.Conv2d(cout * 2, cout, 3, padding=0 if tf_variant else dilation,
                          dilation=dilation, bias=tf_variant),
            ),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf_variant:
            return self.atrous_conv(x)
        x = F.pad(x, (self.dilation,) * 4)
        if "first_bn" in self.atrous_conv._modules:
            x = self.atrous_conv.first_bn(x)
        relu, conv1, bn2, relu2, conv2 = self.atrous_conv.aconv_sequence
        return conv2(relu2(bn2(F.elu(conv1(relu(x))))))


class Reduction1x1(nn.Module):
    """Chain of 1x1 convs halving channels to < 8, ending in a 1-channel
    sigmoid head (final, NCHW) or a 3-channel plane head decoded in f32 to
    a unit plane equation in ``(B, H, W, 4)``."""

    def __init__(
        self,
        num_in: int,
        num_out: int,
        max_depth: float,
        is_final: bool = False,
        theta_max: float = math.pi / 3,
        bias: bool = False,
    ):
        super().__init__()
        self.max_depth = max_depth
        self.is_final = is_final
        self.theta_max = theta_max
        self.reduc = nn.Sequential()
        while num_out >= 4:
            if num_out < 8:
                if is_final:
                    self.reduc.add_module(
                        "final",
                        nn.Sequential(nn.Conv2d(num_in, 1, 1, bias=bias), nn.Sigmoid()),
                    )
                else:
                    self.reduc.add_module(
                        "plane_params", nn.Conv2d(num_in, 3, 1, bias=bias)
                    )
                break
            self.reduc.add_module(
                f"inter_{num_in}_{num_out}",
                nn.Sequential(nn.Conv2d(num_in, num_out, 1, bias=bias), nn.ELU()),
            )
            num_in, num_out = num_out, num_out // 2
        else:
            raise ValueError("num_out_filters must be >= 4")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.reduc(x)
        if self.is_final:
            return x
        raw = x.float().permute(0, 2, 3, 1)
        return decode_plane_eq(raw, self.max_depth, self.theta_max)


class BTSDecoder(nn.Module):
    """5 skips [H/2 .. H/32] (NCHW) + focal (B,) -> (depth_8x8_scaled,
    depth_4x4_scaled, depth_2x2_scaled, reduc1x1, final_depth), each
    (B, 1, H, W) float32. ``flavor``: 'pt' (pytorch/bts.py) or 'tf'
    (tensorflow/bts.py), see the module's docstring."""

    def __init__(
        self,
        feat_out_channels: Sequence[int],
        num_features: int = 512,
        max_depth: float = 10.0,
        dataset: str = "nyu",
        lpg_impl: str = "auto",
        flavor: str = "pt",
    ):
        super().__init__()
        if flavor not in FLAVORS:
            raise ValueError(f"flavor must be 'pt' or 'tf' (got {flavor!r})")
        nf, fc = num_features, feat_out_channels
        self.max_depth = max_depth
        self.dataset = dataset
        self.lpg_impl = lpg_impl
        self.flavor = flavor
        tf = flavor == "tf"
        theta_max = math.pi / 6 if tf else math.pi / 3

        def reduc(num_in, num_out, is_final=False):
            return Reduction1x1(num_in, num_out, max_depth, is_final, theta_max, bias=tf)

        def atrous(cin, rate, apply_bn_first=True):
            return AtrousConv(cin, nf // 4, rate, apply_bn_first, tf_variant=tf)

        self.upconv5 = UpConv(fc[4], nf, bias=tf)
        self.bn5 = decoder_bn(nf)
        self.conv5 = _conv_elu(nf + fc[3], nf, tf)

        self.upconv4 = UpConv(nf, nf // 2, bias=tf)
        self.bn4 = decoder_bn(nf // 2)
        self.conv4 = _conv_elu(nf // 2 + fc[2], nf // 2, tf)
        self.bn4_2 = decoder_bn(nf // 2)

        self.daspp_3 = atrous(nf // 2, 3, apply_bn_first=False)
        self.daspp_6 = atrous(nf // 2 + nf // 4 + fc[2], 6)
        self.daspp_12 = atrous(nf + fc[2], 12)
        self.daspp_18 = atrous(nf + nf // 4 + fc[2], 18)
        self.daspp_24 = atrous(nf + nf // 2 + fc[2], 24)
        self.daspp_conv = _conv_elu(nf + nf // 2 + nf // 4, nf // 4, tf)
        self.reduc8x8 = reduc(nf // 4, nf // 4)

        self.upconv3 = UpConv(nf // 4, nf // 4, bias=tf)
        self.bn3 = decoder_bn(nf // 4)
        self.conv3 = _conv_elu(nf // 4 + fc[1] + 1, nf // 4, tf)
        self.reduc4x4 = reduc(nf // 4, nf // 8)

        self.upconv2 = UpConv(nf // 4, nf // 8, bias=tf)
        self.bn2 = decoder_bn(nf // 8)
        self.conv2 = _conv_elu(nf // 8 + fc[0] + 1, nf // 8, tf)
        self.reduc2x2 = reduc(nf // 8, nf // 16)

        self.upconv1 = UpConv(nf // 8, nf // 16, bias=tf)
        # TF passes the full width into the final reduction
        # (tensorflow/bts.py:316): one more conv than PT's nf//32 start.
        self.reduc1x1 = reduc(nf // 16, nf // 16 if tf else nf // 32, is_final=True)
        self.conv1 = _conv_elu(nf // 16 + 4, nf // 16, tf)
        self.get_depth = nn.Sequential(
            nn.Conv2d(nf // 16, 1, 3, padding=1, bias=tf), nn.Sigmoid()
        )
        # PT samples the guidance maps every r/2 pixels; TF on the
        # align-corners grid (tensorflow/bts.py:66-73,281,296).
        self._guidance = downsample_nearest_ac if tf else downsample_nearest

    def _lpg_scaled(self, plane_eq: torch.Tensor, r: int, dtype) -> torch.Tensor:
        """Full-resolution LPG map / max_depth in the compute dtype, (B,1,H,W):
        one kernel launch on a card, scale and cast included."""
        plane_eq = normalize_plane(plane_eq).contiguous()
        depth = local_planar_guidance(plane_eq, r, impl=self.lpg_impl,
                                      max_depth=self.max_depth, out_dtype=dtype)
        return depth.unsqueeze(1)

    def forward(
        self, features: Sequence[torch.Tensor], focal: torch.Tensor
    ) -> Tuple[torch.Tensor, ...]:
        skip0, skip1, skip2, skip3 = features[:4]
        dense_features = F.relu(features[4])

        upconv5 = self.bn5(self.upconv5(dense_features))
        iconv5 = self.conv5(torch.cat([upconv5, skip3], dim=1))

        upconv4 = self.bn4(self.upconv4(iconv5))
        concat4 = torch.cat([upconv4, skip2], dim=1)
        iconv4 = self.bn4_2(self.conv4(concat4))

        daspp_3 = self.daspp_3(iconv4)
        concat4_2 = torch.cat([concat4, daspp_3], dim=1)
        daspp_6 = self.daspp_6(concat4_2)
        concat4_3 = torch.cat([concat4_2, daspp_6], dim=1)
        daspp_12 = self.daspp_12(concat4_3)
        concat4_4 = torch.cat([concat4_3, daspp_12], dim=1)
        daspp_18 = self.daspp_18(concat4_4)
        concat4_5 = torch.cat([concat4_4, daspp_18], dim=1)
        daspp_24 = self.daspp_24(concat4_5)
        concat4_daspp = torch.cat(
            [iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], dim=1
        )
        daspp_feat = self.daspp_conv(concat4_daspp)
        dt = daspp_feat.dtype  # the compute dtype (bf16 under autocast)

        # Guidance maps at H/4 and H/2 are the full-resolution maps sampled:
        # for PT every r/2 pixels, exactly bts_tpu's lpg_expand(e=2, base=0,
        # step=r/2); for TF on the align-corners grid. Either way a forward
        # is three LPG launches.
        depth_8x8_scaled = self._lpg_scaled(self.reduc8x8(daspp_feat), 8, dt)
        depth_8x8_scaled_ds = self._guidance(depth_8x8_scaled, 4)

        upconv3 = self.bn3(self.upconv3(daspp_feat))
        iconv3 = self.conv3(torch.cat([upconv3, skip1, depth_8x8_scaled_ds], dim=1))
        depth_4x4_scaled = self._lpg_scaled(self.reduc4x4(iconv3), 4, dt)
        depth_4x4_scaled_ds = self._guidance(depth_4x4_scaled, 2)

        upconv2 = self.bn2(self.upconv2(iconv3))
        iconv2 = self.conv2(torch.cat([upconv2, skip0, depth_4x4_scaled_ds], dim=1))
        depth_2x2_scaled = self._lpg_scaled(self.reduc2x2(iconv2), 2, dt)

        upconv1 = self.upconv1(iconv2)
        reduc1x1 = self.reduc1x1(upconv1)
        iconv1 = self.conv1(
            torch.cat(
                [upconv1, reduc1x1, depth_2x2_scaled, depth_4x4_scaled, depth_8x8_scaled],
                dim=1,
            )
        )
        # The final sigmoid runs in f32, as in bts_tpu.
        logits = self.get_depth[0](iconv1)
        final_depth = self.max_depth * torch.sigmoid(logits.float())
        if self.dataset == "kitti":
            final_depth = final_depth * (focal.float()[:, None, None, None] / 715.0873)
        return (
            depth_8x8_scaled.float(),
            depth_4x4_scaled.float(),
            depth_2x2_scaled.float(),
            reduc1x1.float(),
            final_depth,
        )
