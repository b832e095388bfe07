"""NeWCRFs (Yuan, Gu, Dai, Zhu, Tan, "Neural Window Fully-connected CRFs
for Monocular Depth Estimation", CVPR 2022; aliyun/NeWCRFs,
``newcrfs/networks/NewCRFDepth.py``, ``newcrf_layers.py``,
``uper_crf_head.py``) for inference: a Swin backbone
(``encoders/swin.py``), a pyramid-pooling head on its coarsest map, and four
window-attention CRF levels from coarse to fine, then a sigmoid depth head.

Module names follow upstream's (``backbone.*``, ``decoder.*``, ``crf0`` ...
``crf3``, ``disp_head1``), so a published checkpoint's state dict loads with
``strict=True``. ``VERSIONS`` holds the widths by upstream's ``--encoder``
name; ``large07`` is Swin-L with 7x7 windows.

- ``decoder`` (PSP): each pool scale (1, 2, 3, 6) is an adaptive average
  pool, a 1x1 convolution without bias, a GroupNorm of 256 groups and a
  ReLU, resized bilinearly (``align_corners=False``) to the map; the input
  and the four are concatenated into a 3x3 convolution, BatchNorm, ReLU.
  Upstream's ``PPM`` sets GroupNorm for pool scale 1 ("if batch size = 1,
  BN is not supported") by reassigning its loop's ``norm_cfg``, so every
  later scale takes it too.
- ``NewCRF`` level: ``proj_x`` Conv3x3(in -> dim) of the encoder's map,
  ``proj_v`` Conv3x3(v -> dim) of the coarser prediction, two blocks
  (shift 0, then window // 2), ``norm_crf``. A block: ``x̂ = norm1(x)``;
  Q, K = ``qk(x̂)``; V is the level's projected prediction, padded, rolled
  and windowed as x̂, without a norm; the window attention with Swin's
  relative-position bias and shift mask, then ``proj``; ``x = x + attn``;
  ``x = x + MLP(norm2(x))``. V is the same for both blocks. As in Swin's
  blocks (``encoders/swin.py``), the port makes no padded, rolled or
  windowed copy: the attention reads the grid, a padded token's K is
  ``qk``'s bias and its V zero, and V is laid out (B, h, w, C) once a
  level.
- Between levels PixelShuffle(2); ``disp_head1`` is Conv3x3(dim0 -> 1), a
  sigmoid (in float32) and a bilinear x4 resize; depth = that * max_depth.

The forward takes ``(image, focal)`` and ignores the focal, as upstream's
does not take one; it returns ``(depth,)``, (B, 1, H, W) float32. An
inference forward on a card replays a CUDA graph of itself
(``models/graphed.py``). The spans ``newcrfs/encoder`` and
``newcrfs/decoder`` name the two halves in a profile; every block's
attention is one launch of ``ops/window_attention``'s kernel (32 a forward
for ``large07``), every LayerNorm one of ``ops/layer_norm``'s
(``layers.LayerNorm``; 76 a forward), and every bilinear resize one of
``ops/resize``'s (5 a forward, each writing float32: the PSP's four, which
the bottleneck convolution rounds with the rest of the concatenation, and
the depth's). Training is not supported: the kernels have no backward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from bts_tpu_torch.models.encoders.swin import (SwinTransformer, relative_position_index,
                                                shift_mask)
from bts_tpu_torch.models.graphed import GraphedForward
from bts_tpu_torch.models.layers import LayerNorm, Mlp, seeded_init
from bts_tpu_torch.ops.resize import bilinear
from bts_tpu_torch.ops.window_attention import padded_grid, window_attention

# Upstream's --encoder names and their widths (NewCRFDepth.__init__).
VERSIONS = {
    "large07": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                    crf_dims=(128, 256, 512, 1024), crf_heads=(4, 8, 16, 32), psp_channels=512,
                    psp_groups=256),
}
WINDOW = 7  # Swin's (the "07" of large07) and every CRF level's (upstream's win = 7)
CRF_DEPTH = 2  # blocks a CRF level: shift 0, then WINDOW // 2
POOL_SCALES = (1, 2, 3, 6)


class CRFWindowAttention(nn.Module):
    """Q and K from the encoder's stream (``qk`` Linear(C, 2C)), V from the
    prediction's; the relative-position bias; ``proj`` Linear(C, C)."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qk = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor, h: int, w: int, shift: int,
                mask=None) -> torch.Tensor:
        """x (B, h*w, C) normed tokens, v (B, h, w, C) -> (B, h*w, C)."""
        b, _, c = x.shape
        heads = self.num_heads
        qk = self.qk(x).view(b, h, w, 2, heads, c // heads)
        k_pad = self.qk.bias.view(2, c)[1]
        out = window_attention(qk[..., 0, :, :], qk[..., 1, :, :], v.view(b, h, w, heads, -1),
                               self.relative_position_bias_table,
                               self.relative_position_index, mask, self.scale, self.window,
                               shift, k_pad, None)
        return self.proj(out)


class CRFBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, to_gemm=True)  # read by qk
        self.attn = CRFWindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, to_gemm=True)  # read by mlp.fc1
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor, v: torch.Tensor, h: int, w: int,
                mask: torch.Tensor) -> torch.Tensor:
        """x (B, h*w, C) tokens, v (B, h, w, C) the projected prediction."""
        x = x + self.attn(self.norm1(x), v, h, w, self.shift, mask if self.shift else None)
        return x + self.mlp(self.norm2(x))


class BasicCRFLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList([
            CRFBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth)])

    def forward(self, x: torch.Tensor, v: torch.Tensor, h: int, w: int) -> torch.Tensor:
        hp, wp = padded_grid(h, w, self.window)
        mask = shift_mask(hp, wp, self.window, self.window // 2, x.device)
        for blk in self.blocks:
            x = blk(x, v, h, w, mask)
        return x


class NewCRF(nn.Module):
    """One CRF level: (encoder map (B, in, h, w), prediction (B, v, h, w))
    -> (B, dim, h, w)."""

    def __init__(self, input_dim: int, embed_dim: int, v_dim: int, window: int,
                 num_heads: int, depth: int):
        super().__init__()
        self.proj_x = nn.Conv2d(input_dim, embed_dim, 3, padding=1) \
            if input_dim != embed_dim else None
        self.proj_v = nn.Conv2d(v_dim, embed_dim, 3, padding=1) if v_dim != embed_dim else None
        self.crf_layer = BasicCRFLayer(embed_dim, depth, num_heads, window)
        # Read by the next level's proj_v (after PixelShuffle) or by disp_head1.
        self.norm_crf = LayerNorm(embed_dim, to_gemm=True)

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.proj_x is not None:
            x = self.proj_x(x)
        if self.proj_v is not None:
            v = self.proj_v(v)
        b, c, h, w = x.shape
        v = v.permute(0, 2, 3, 1).contiguous()  # the attention reads V's channels contiguous
        x = self.crf_layer(x.flatten(2).transpose(1, 2), v, h, w)
        return self.norm_crf(x).view(b, h, w, c).permute(0, 3, 1, 2)


class ConvModule(nn.Module):
    """mmcv's ConvModule as upstream builds it: a convolution without bias,
    its norm (``bn`` or ``gn``, named as mmcv names them) and a ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, groups: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False)
        if groups:
            self.gn = nn.GroupNorm(groups, cout)
        else:
            self.bn = nn.BatchNorm2d(cout)
        self.activate = nn.ReLU(inplace=True)

    def forward(self, x):
        norm = self.gn if hasattr(self, "gn") else self.bn
        return self.activate(norm(self.conv(x)))


class PSP(nn.Module):
    """The pyramid-pooling head on the coarsest map (module docstring)."""

    def __init__(self, in_channels: int, channels: int, pool_scales: Sequence[int],
                 groups: int):
        super().__init__()
        self.psp_modules = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(in_channels, channels, 1, groups))
            for s in pool_scales])
        self.bottleneck = ConvModule(in_channels + len(pool_scales) * channels, channels, 3)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = feats[-1]
        # float32, as norm3's map x: the bottleneck rounds the concatenation.
        pooled = [bilinear(m(x), x.shape[2:], False, torch.float32) for m in self.psp_modules]
        return self.bottleneck(torch.cat([x, *pooled], 1))


class DispHead(nn.Module):
    def __init__(self, input_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, 1, 3, padding=1)

    def forward(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        x = torch.sigmoid(self.conv1(x).float())
        return bilinear(x, (scale * x.shape[2], scale * x.shape[3]), False, torch.float32)


class NeWCRFsModel(GraphedForward):
    """image (B, 3, H, W) normalized, focal (B,) (ignored) -> (depth,),
    (B, 1, H, W) float32; H and W multiples of 32 (``apps/predict``'s
    ``forward_padded`` pads them). The widths default to ``large07``."""

    OUTPUTS = ("depth",)
    TRAINS = False
    PAD_MULTIPLE = 32  # Swin's four stages halve the 4x4 patch grid three times

    def __init__(self, max_depth: float = 10.0, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (6, 12, 24, 48),
                 crf_dims: Sequence[int] = (128, 256, 512, 1024),
                 crf_heads: Sequence[int] = (4, 8, 16, 32), psp_channels: int = 512,
                 psp_groups: int = 256):
        super().__init__()
        self.max_depth = float(max_depth)
        self.backbone = SwinTransformer(embed_dim, depths, num_heads, WINDOW)
        feats = self.backbone.num_features
        # Each level's prediction is the next coarser level's output after
        # PixelShuffle(2) (a quarter of its channels); the coarsest takes the PSP's.
        v_dims = [d // 4 for d in crf_dims[1:]] + [psp_channels]
        for i in reversed(range(len(crf_dims))):
            self.add_module(f"crf{i}", NewCRF(feats[i], crf_dims[i], v_dims[i], WINDOW,
                                              crf_heads[i], CRF_DEPTH))
        # norm0-norm2's maps go to their level's proj_x alone, where it has
        # one; the PSP pools norm3's map in float32.
        for i in range(len(crf_dims) - 1):
            norm = getattr(self.backbone, f"norm{i}")
            norm.to_gemm = getattr(self, f"crf{i}").proj_x is not None
        self.decoder = PSP(feats[-1], psp_channels, POOL_SCALES, psp_groups)
        self.disp_head1 = DispHead(crf_dims[0])

    def _forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor]:
        with record_function("newcrfs/encoder"):
            feats = self.backbone(x)
        with record_function("newcrfs/decoder"):
            e = self.decoder(feats)
            for i in reversed(range(len(feats))):
                e = getattr(self, f"crf{i}")(feats[i], e)
                if i:
                    e = F.pixel_shuffle(e, 2)
            depth = self.disp_head1(e, 4) * self.max_depth
        return (depth,)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init from the CPU ``generator`` (``layers.seeded_init``):
    Xavier-uniform convolutions and linear layers, biases 0, the bias tables
    a normal of std 0.02 truncated at +-2 (Swin's), norms at identity."""
    return seeded_init(model, generator, normal=("relative_position_bias_table",))


def create_model(cfg) -> NeWCRFsModel:
    """``NeWCRFsModel`` of ``cfg.encoder``'s widths (``VERSIONS``) at
    ``cfg.max_depth``, on the CPU, its weights seeded from ``cfg.seed``.
    There is no TF graph of it."""
    if cfg.resolved_flavor != "pt":
        raise ValueError(f"--encoder {cfg.encoder} (NeWCRFs) has no TF graph "
                         f"(model_flavor {cfg.resolved_flavor!r})")
    model = NeWCRFsModel(max_depth=cfg.max_depth, **VERSIONS[cfg.encoder])
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))
