"""The DINOv2 ViT as Depth Anything V2 builds it (DepthAnything/
Depth-Anything-V2, ``depth_anything_v2/dinov2.py``: ``DINOv2('vitl')``,
img_size 518, patch 14, LayerScale ``init_values`` 1.0, an MLP of ratio 4,
``block_chunks`` 0, no register tokens, ``interpolate_offset`` 0.1, no
antialias), returning the normed patch tokens of chosen blocks.

Module names follow upstream's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``mask_token``, ``blocks.<i>.{norm1, attn.qkv, attn.proj,
ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}``, ``norm``), so a published
checkpoint's ``pretrained.*`` keys load as they are. The forward, as
upstream computes it in eval:

- ``patch_embed.proj``, a Conv2d(3, C, 14, stride 14), its (h, w) grid of
  tokens flattened; the class token prepended;
- plus the position embedding: its class entry as it is, its grid of
  ``pos_grid`` x ``pos_grid`` entries resized bicubically
  (``align_corners=False``) by the scale factors ((h + 0.1) / pos_grid,
  (w + 0.1) / pos_grid), in float32, to h x w; upstream passes the scale
  factors, not the size, so the source coordinates are (i + 0.5) / s - 0.5
  with s the factor, and the 0.1 keeps floor(pos_grid * s) at h. A square
  grid of pos_grid x pos_grid tokens takes the table as it is;
- blocks: ``x = x + ls1(attn(norm1(x)))``, ``x = x + ls2(mlp(norm2(x)))``,
  LayerNorm eps 1e-6, LayerScale a learned vector (``gamma``) times x, the
  attention global over all 1 + h * w tokens
  (``ops/global_attention``: ``softmax(q k^T / sqrt(d)) v`` a head, read
  from ``qkv``'s output as it is), the MLP GELU (erf);
- the outputs of the blocks in ``taps``, each through the final ``norm``,
  the class token dropped: (B, h * w, C) each.

``mask_token`` is a parameter that the forward never reads (upstream's
masked training); it is kept so that a checkpoint loads with
``strict=True``. Every norm is ``layers.LayerNorm`` (the kernel on a card);
under autocast each writes the autocast dtype, since a Linear (``qkv``,
``fc1``) or a convolution (the head's ``projects``) reads it. The residual
stream is float32: the class token and the position embedding are.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import LayerNorm, Mlp
from bts_tpu_torch.ops.global_attention import global_attention

PATCH = 14  # DINOv2's patch
MLP_RATIO = 4
INTERPOLATE_OFFSET = 0.1
NORM_EPS = 1e-6


class Attention(nn.Module):
    """``qkv`` Linear(C, 3C) with bias, global attention, ``proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
        return self.proj(global_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                          self.scale))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, to_gemm=True, eps=NORM_EPS)  # read by attn.qkv
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, to_gemm=True, eps=NORM_EPS)  # read by mlp.fc1
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, PATCH, stride=PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    """image (B, 3, H, W), H and W multiples of 14 -> the normed patch
    tokens (B, H/14 * W/14, C) of each block in ``taps``."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, pos_grid: int,
                 taps: Sequence[int]):
        super().__init__()
        self.taps = tuple(taps)
        self.pos_grid = pos_grid
        self.patch_embed = PatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, to_gemm=True, eps=NORM_EPS)  # read by the head
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))  # not read

    def position_embedding(self, h: int, w: int) -> torch.Tensor:
        """(1, 1 + h * w, C) float32: the table resized to an h x w grid
        (module docstring), made each forward."""
        pos = self.pos_embed.float()
        g = self.pos_grid
        if h == w == g:
            return pos
        grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((h + INTERPOLATE_OFFSET) / g,
                                                 (w + INTERPOLATE_OFFSET) / g),
                             mode="bicubic", align_corners=False)
        if grid.shape[-2:] != (h, w):
            raise ValueError(f"the position embedding resized to {tuple(grid.shape[-2:])}, "
                             f"not the {h}x{w} patch grid")
        return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, w = x.shape[-2] // PATCH, x.shape[-1] // PATCH
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x.float()], 1)
        x = x + self.position_embedding(h, w)
        outs = []
        for i, blk in enumerate(self.blocks[:max(self.taps) + 1]):
            x = blk(x)
            if i in self.taps:
                outs.append(self.norm(x)[:, 1:])
        return outs
