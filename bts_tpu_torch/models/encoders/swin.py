"""The Swin Transformer backbone as NeWCRFs builds it (aliyun/NeWCRFs,
``newcrfs/networks/swin_transformer.py``: Swin's detection and segmentation
variant, four outputs with a LayerNorm each), and the shifted-window
helpers that its CRF decoder shares (``models/newcrfs.py``).

Module names follow upstream's (``patch_embed``, ``layers.<i>.blocks.<j>``,
``layers.<i>.downsample``, ``norm0`` ... ``norm3``), so a published
checkpoint's ``backbone.*`` keys load as they are, the
``relative_position_index`` buffers among them. A block, as upstream
computes it:

- ``x̂ = norm1(x)``, padded with zeros at the bottom and right to window
  multiples Hp x Wp (the zeros take part as keys, unmasked, as upstream's);
- odd blocks roll x̂ by (-shift, -shift), shift = window // 2, and mask the
  pairs of tokens that the roll brought together (-100, Swin's mask over
  Hp x Wp, ``shift_mask``);
- window attention with a relative-position bias, then ``proj``; the roll
  undone and the padding cut off; ``x = x + attn``; ``x = x + MLP(norm2(x))``
  (GELU).

The port makes no padded, rolled or windowed copy: ``qkv`` and ``proj``
act token by token, so they run on the h*w tokens, and
``ops/window_attention`` (the kernel on a card) reads each window's tokens
from the grid, gives a padded token the K and V that ``qkv`` makes of zeros
(its bias), and writes each output row back to its token.

Patch embedding is a 4x4/4 convolution and a LayerNorm; patch merging
gathers each 2x2 block of tokens (LayerNorm(4C), Linear(4C, 2C) without
bias). Drop-path and dropout are inactive in eval and are left out.

Every LayerNorm is ``layers.LayerNorm`` (``ops/layer_norm``, the kernel on a
card): float32 arithmetic, as autocast runs ``nn.LayerNorm``, and under
autocast a norm whose one reader is a Linear or a convolution writes the
autocast dtype itself. So stage 1's residual stream, which
``patch_embed.norm`` writes, is float32; stages 2-4 start from
``PatchMerging.reduction``'s output, in the autocast dtype.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import LayerNorm, Mlp
from bts_tpu_torch.ops.window_attention import padded_grid, window_attention

MASKED = -100.0  # Swin's additive mask for tokens the cyclic shift brought together
PATCH = 4  # the patch embedding's kernel and stride
MLP_RATIO = 4  # each block's MLP width over its channels


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) int64, N = window^2: the row of the bias table ((2w-1)^2, heads)
    that each pair of a window's tokens reads, as Swin computes it."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    region = torch.zeros(hp, wp, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cuts):
            region[hs, ws] = 3 * i + j
    windows = window_partition(region[None, :, :, None], window)[..., 0]  # (nW, N)
    pairs = windows[:, None, :] - windows[:, :, None]
    return torch.zeros_like(pairs).masked_fill(pairs != 0, MASKED)


@functools.lru_cache(maxsize=None)
def _cached_shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return _shift_mask(hp, wp, window, shift, device)


def shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """(nW, N, N) float32 on ``device``: 0 for two tokens of a shifted window
    that lie in the same region of the padded Hp x Wp map, -100 for two the
    cyclic shift brought together. Made once a shape and device, and kept;
    inside a CUDA graph's capture it is made anew (as nodes of the graph)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return _shift_mask(hp, wp, window, shift, device)
    return _cached_shift_mask(hp, wp, window, shift, device)


class WindowAttention(nn.Module):
    """Swin's windowed multi-head self-attention: ``qkv`` Linear(C, 3C) with
    bias, the relative-position bias, ``proj`` Linear(C, C)."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int, shift: int, mask=None) -> torch.Tensor:
        """x (B, h*w, C) normed tokens -> (B, h*w, C); windows of the grid
        rolled by (-shift, -shift), ``mask`` over its padded Hp x Wp."""
        b, _, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).view(b, h, w, 3, heads, c // heads)
        _, k_pad, v_pad = self.qkv.bias.view(3, c)
        out = window_attention(qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :],
                               self.relative_position_bias_table,
                               self.relative_position_index, mask, self.scale, self.window,
                               shift, k_pad, v_pad)
        return self.proj(out)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, to_gemm=True)  # read by qkv
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, to_gemm=True)  # read by mlp.fc1
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor, h: int, w: int, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w, self.shift, mask if self.shift else None)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, to_gemm=True)  # read by reduction

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    """One stage: blocks alternating shift 0 and window // 2, then patch
    merging unless it is the last."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, downsample: bool):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor, h: int, w: int):
        """-> (the stage's tokens (B, h*w, C), the next stage's tokens, its h, w)."""
        hp, wp = padded_grid(h, w, self.window)
        mask = shift_mask(hp, wp, self.window, self.window // 2, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, mask)
        if self.downsample is None:
            return x, x, h, w
        return x, self.downsample(x, h, w), (h + 1) // 2, (w + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, PATCH, stride=PATCH)
        self.norm = LayerNorm(embed_dim, to_gemm=False)  # stage 1's residual stream

    def forward(self, x: torch.Tensor):
        """image (B, 3, H, W) -> tokens (B, h*w, C), h, w."""
        h, w = x.shape[-2:]
        x = self.proj(F.pad(x, (0, (-w) % PATCH, 0, (-h) % PATCH)))
        return self.norm(x.flatten(2).transpose(1, 2).contiguous()), x.shape[2], x.shape[3]


class SwinTransformer(nn.Module):
    """image (B, 3, H, W) -> four maps (B, C*2^i, H/2^(i+2), W/2^(i+2)), each
    after its LayerNorm ``norm<i>``, in float32 (``to_gemm`` false): the
    model that reads a map sets its norm's ``to_gemm`` where a Linear or a
    convolution is its one reader."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window: int):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.num_features = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList([
            BasicLayer(self.num_features[i], depths[i], num_heads[i], window,
                       downsample=i < len(depths) - 1) for i in range(len(depths))])
        for i, c in enumerate(self.num_features):
            self.add_module(f"norm{i}", LayerNorm(c, to_gemm=False))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b = x.shape[0]
        x, h, w = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            out, x, nh, nw = layer(x, h, w)
            out = getattr(self, f"norm{i}")(out)
            outs.append(out.view(b, h, w, -1).permute(0, 3, 1, 2))
            h, w = nh, nw
        return outs

