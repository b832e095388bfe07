"""BTS decoder: U-Net with Dense-ASPP and multi-scale Local Planar Guidance.

Port of ``bts_tpu/models/decoder.py`` (PT flavor, plain tail), NCHW. Module
names are the reference PyTorch decoder's, which ``bts_tpu``'s converter
maps, so reference state dicts load as they are. ``bts_tpu``'s TPU layout
rewrites (fused lhs-dilated upconv, SplitConv, the space-to-depth tail) are
exact math against this plain graph and are not carried over.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import decoder_bn, downsample_nearest, upsample_nearest
from bts_tpu_torch.ops.lpg import decode_plane_eq, local_planar_guidance, normalize_plane


def _conv_elu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.ELU())


class UpConv(nn.Module):
    """Nearest upsample x ratio -> 3x3 conv -> ELU."""

    def __init__(self, cin: int, cout: int, ratio: int = 2):
        super().__init__()
        self.ratio = ratio
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(upsample_nearest(x, self.ratio)))


class AtrousConv(nn.Module):
    """(optional BN) -> ReLU -> 1x1 conv(2C) -> BN -> ReLU -> 3x3 dilated conv.

    First BN eps 1.1e-5, the inner BN torch's default 1e-5 (momentum 0.01).
    """

    def __init__(self, cin: int, cout: int, dilation: int, apply_bn_first: bool = True):
        super().__init__()
        self.atrous_conv = nn.Sequential()
        if apply_bn_first:
            self.atrous_conv.add_module("first_bn", decoder_bn(cin))
        self.atrous_conv.add_module(
            "aconv_sequence",
            nn.Sequential(
                nn.ReLU(),
                nn.Conv2d(cin, cout * 2, 1, bias=False),
                decoder_bn(cout * 2, eps=1e-5),
                nn.ReLU(),
                nn.Conv2d(
                    cout * 2, cout, 3, padding=dilation, dilation=dilation, bias=False
                ),
            ),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.atrous_conv(x)


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
                        nn.Sequential(nn.Conv2d(num_in, 1, 1, bias=False), nn.Sigmoid()),
                    )
                else:
                    self.reduc.add_module(
                        "plane_params", nn.Conv2d(num_in, 3, 1, bias=False)
                    )
                break
            self.reduc.add_module(
                f"inter_{num_in}_{num_out}",
                nn.Sequential(nn.Conv2d(num_in, num_out, 1, bias=False), nn.ELU()),
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
    (B, 1, H, W) float32."""

    def __init__(
        self,
        feat_out_channels: Sequence[int],
        num_features: int = 512,
        max_depth: float = 10.0,
        dataset: str = "nyu",
        lpg_impl: str = "auto",
    ):
        super().__init__()
        nf, fc = num_features, feat_out_channels
        self.max_depth = max_depth
        self.dataset = dataset
        self.lpg_impl = lpg_impl

        self.upconv5 = UpConv(fc[4], nf)
        self.bn5 = decoder_bn(nf)
        self.conv5 = _conv_elu(nf + fc[3], nf)

        self.upconv4 = UpConv(nf, nf // 2)
        self.bn4 = decoder_bn(nf // 2)
        self.conv4 = _conv_elu(nf // 2 + fc[2], nf // 2)
        self.bn4_2 = decoder_bn(nf // 2)

        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False)
        self.daspp_6 = AtrousConv(nf // 2 + nf // 4 + fc[2], nf // 4, 6)
        self.daspp_12 = AtrousConv(nf + fc[2], nf // 4, 12)
        self.daspp_18 = AtrousConv(nf + nf // 4 + fc[2], nf // 4, 18)
        self.daspp_24 = AtrousConv(nf + nf // 2 + fc[2], nf // 4, 24)
        self.daspp_conv = _conv_elu(nf + nf // 2 + nf // 4, nf // 4)
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth)

        self.upconv3 = UpConv(nf // 4, nf // 4)
        self.bn3 = decoder_bn(nf // 4)
        self.conv3 = _conv_elu(nf // 4 + fc[1] + 1, nf // 4)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth)

        self.upconv2 = UpConv(nf // 4, nf // 8)
        self.bn2 = decoder_bn(nf // 8)
        self.conv2 = _conv_elu(nf // 8 + fc[0] + 1, nf // 8)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth)

        self.upconv1 = UpConv(nf // 8, nf // 16)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth, is_final=True)
        self.conv1 = _conv_elu(nf // 16 + 4, nf // 16)
        self.get_depth = nn.Sequential(
            nn.Conv2d(nf // 16, 1, 3, padding=1, bias=False), nn.Sigmoid()
        )

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

        # Guidance maps at H/4 and H/2 are the full-resolution maps sampled
        # every r/2 pixels: exactly bts_tpu's lpg_expand(e=2, base=0, step=r/2).
        depth_8x8_scaled = self._lpg_scaled(self.reduc8x8(daspp_feat), 8, dt)
        depth_8x8_scaled_ds = downsample_nearest(depth_8x8_scaled, 4)

        upconv3 = self.bn3(self.upconv3(daspp_feat))
        iconv3 = self.conv3(torch.cat([upconv3, skip1, depth_8x8_scaled_ds], dim=1))
        depth_4x4_scaled = self._lpg_scaled(self.reduc4x4(iconv3), 4, dt)
        depth_4x4_scaled_ds = downsample_nearest(depth_4x4_scaled, 2)

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
