"""Depth Anything V2, metric (Yang, Kang, Huang, Zhao, Xu, Feng, Zhao,
"Depth Anything V2", NeurIPS 2024; DepthAnything/Depth-Anything-V2,
``metric_depth/depth_anything_v2/dpt.py``) for inference: a DINOv2 ViT
(``encoders/vit.py``) whose four tapped blocks feed a DPT head, a sigmoid
times ``max_depth``.

Module names follow upstream's (``pretrained.*``, ``depth_head.projects``,
``depth_head.resize_layers``, ``depth_head.scratch.layer<i>_rn``,
``depth_head.scratch.refinenet<i>.{resConfUnit1, resConfUnit2, out_conv}``,
``depth_head.scratch.output_conv1``, ``depth_head.scratch.output_conv2``),
so a published checkpoint (``depth_anything_v2_metric_vkitti_vitl.pth``, a
bare state dict) loads with ``strict=True``. ``VERSIONS`` holds the widths
by ``--encoder`` name; ``dav2_vitl`` is ViT-L/14 with upstream's taps and
``metric_depth/run.py``'s input size 518.

The forward, as upstream's ``infer_image(raw, 518)`` and ``forward``
compute it, with the frame's resizes on the card:

- the normalized frame (B, 3, H, W) resized bicubically
  (``align_corners=False``) to ``model_input``: both sides at least
  ``input_size`` and multiples of 14, the aspect kept (upstream's
  ``Resize``, lower bound, cv2's cubic on the host before the per-channel
  normalization, which commutes with it);
- the encoder's tapped tokens, each reshaped to (B, C, h, w), through
  ``projects[i]`` (1x1) and ``resize_layers[i]`` (ConvTranspose 4/4,
  ConvTranspose 2/2, identity, Conv 3x3/2), then ``layer<i>_rn`` (3x3, no
  bias) to ``features``;
- fusion from coarse to fine: ``refinenet4(l4)``, ``refinenet<i>(p, l<i>)``
  = ``out_conv(resize(rcu2(p + rcu1(l<i>))))``, each residual unit
  ``conv2(relu(conv1(relu(x)))) + x``, the resize bilinear
  (``align_corners=True``) to the next level's size, x2 for
  ``refinenet1``;
- ``output_conv1`` (3x3), a bilinear resize (``align_corners=True``) to the
  model input, ``output_conv2`` = 3x3 conv, ReLU, 1x1 conv, sigmoid; times
  ``max_depth``; resized back to H x W (bilinear, ``align_corners=True``).

Under autocast the last 1x1 convolution, the sigmoid, the scale and the
final resize run in float32, as ``newcrfs.DispHead`` does: in bf16, 80
times a sigmoid would step by 0.16-0.3 m.

The forward takes ``(image, focal)`` and ignores the focal; it returns
``(depth,)``, (B, 1, H, W) float32, for any H and W (``PAD_MULTIPLE`` 1:
the model resizes its frame itself). An inference forward on a card
replays a CUDA graph of itself (``models/graphed.py``). The spans
``dav2/encoder`` and ``dav2/head`` name the two parts in a profile; every
block's attention is one launch of ``ops/global_attention``'s kernel (24 a
forward for ``dav2_vitl``), every LayerNorm one of ``ops/layer_norm``'s
(52), and every bilinear resize one of ``ops/resize``'s (6: the head's five
write the dtype the next convolution reads, the depth's float32). Training
is not supported: the kernels have no backward.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from bts_tpu_torch.models.encoders.vit import PATCH, DinoVisionTransformer
from bts_tpu_torch.models.graphed import GraphedForward
from bts_tpu_torch.models.layers import gemm_dtype, seeded_init
from bts_tpu_torch.ops.resize import bilinear

# --encoder names and their widths (upstream's DINOv2('vitl'), dpt.py's
# intermediate_layer_idx['vitl'] and model_configs['vitl'], run.py's
# --input-size).
VERSIONS = {
    "dav2_vitl": dict(embed_dim=1024, depth=24, num_heads=16, pos_grid=37, taps=(4, 11, 17, 23),
                      features=256, out_channels=(256, 512, 1024, 1024), input_size=518),
}
HEAD_HIDDEN = 32  # output_conv2's width (upstream's head_features_2)


def model_input(h: int, w: int, input_size: int) -> Tuple[int, int]:
    """The size a frame of h x w is resized to: each side s * side rounded
    to a multiple of 14 (half to even, as numpy rounds), s = max(input_size
    / h, input_size / w), rounded up instead where that falls under
    ``input_size``."""
    s = max(input_size / h, input_size / w)

    def side(x):
        y = round(s * x / PATCH) * PATCH
        return y if y >= input_size else math.ceil(s * x / PATCH) * PATCH

    return side(h), side(w)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)  # unread by refinenet4, as upstream's
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x: torch.Tensor, skip=None, size=None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size if size is not None else (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(bilinear(x, size, True, gemm_dtype(x)))


class DPTHead(nn.Module):
    """Four tapped token maps (B, h * w, C) -> the sigmoid (B, 1, 14h, 14w),
    float32."""

    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        self.projects = nn.ModuleList([nn.Conv2d(in_channels, c, 1) for c in out_channels])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, stride=4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, c in enumerate(out_channels):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(len(out_channels)):
            setattr(self.scratch, f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, HEAD_HIDDEN, 3, padding=1), nn.ReLU(True),
            nn.Conv2d(HEAD_HIDDEN, 1, 1), nn.Sigmoid())

    def forward(self, feats: Sequence[torch.Tensor], h: int, w: int) -> torch.Tensor:
        s = self.scratch
        maps = []
        for i, x in enumerate(feats):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], h, w)
            x = self.resize_layers[i](self.projects[i](x))
            maps.append(getattr(s, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = maps
        p = s.refinenet4(l4, size=l3.shape[2:])
        p = s.refinenet3(p, l3, size=l2.shape[2:])
        p = s.refinenet2(p, l2, size=l1.shape[2:])
        p = s.refinenet1(p, l1)
        p = s.output_conv1(p)
        x = bilinear(p, (h * PATCH, w * PATCH), True, gemm_dtype(p))
        conv, relu, last, sigmoid = s.output_conv2
        x = relu(conv(x))
        with torch.autocast(x.device.type, enabled=False):
            return sigmoid(last(x.float()))


class DepthAnythingV2Model(GraphedForward):
    """image (B, 3, H, W) normalized, any H and W, focal (B,) (ignored) ->
    (depth,), (B, 1, H, W) float32. The widths default to ``dav2_vitl``."""

    OUTPUTS = ("depth",)
    TRAINS = False
    PAD_MULTIPLE = 1  # the forward resizes its frame itself

    def __init__(self, max_depth: float = 80.0, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, pos_grid: int = 37, taps: Sequence[int] = (4, 11, 17, 23),
                 features: int = 256, out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 input_size: int = 518):
        super().__init__()
        self.max_depth = float(max_depth)
        self.input_size = input_size
        self.pretrained = DinoVisionTransformer(embed_dim, depth, num_heads, pos_grid, taps)
        self.depth_head = DPTHead(embed_dim, features, out_channels)

    def _forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor]:
        h, w = x.shape[-2:]
        mh, mw = model_input(h, w, self.input_size)
        with record_function("dav2/encoder"):
            if (mh, mw) != (h, w):
                x = F.interpolate(x, (mh, mw), mode="bicubic", align_corners=False)
            feats = self.pretrained(x)
        with record_function("dav2/head"):
            depth = self.depth_head(feats, mh // PATCH, mw // PATCH)
            with torch.autocast(depth.device.type, enabled=False):
                depth = bilinear(depth * self.max_depth, (h, w), True, torch.float32)
        return (depth,)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init from the CPU ``generator`` (``layers.seeded_init``):
    Xavier-uniform convolutions, transposed convolutions and linear layers,
    biases 0, norms at identity, LayerScale at upstream's ``init_values``
    1.0, the class and mask tokens and the position table a normal of std
    0.02 truncated at +-2 (DINOv2's)."""
    return seeded_init(model, generator, normal=("cls_token", "pos_embed", "mask_token"),
                       ones=("weight", "gamma"))


def create_model(cfg) -> DepthAnythingV2Model:
    """``DepthAnythingV2Model`` of ``cfg.encoder``'s widths (``VERSIONS``)
    at ``cfg.max_depth``, on the CPU, its weights seeded from ``cfg.seed``.
    There is no TF graph of it."""
    if cfg.resolved_flavor != "pt":
        raise ValueError(f"--encoder {cfg.encoder} (Depth Anything V2) has no TF graph "
                         f"(model_flavor {cfg.resolved_flavor!r})")
    model = DepthAnythingV2Model(max_depth=cfg.max_depth, **VERSIONS[cfg.encoder])
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))
