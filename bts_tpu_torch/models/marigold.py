"""Marigold v1-0 (Ke, Obukhov, Huang, Metzger, Daudt, Schindler,
"Repurposing Diffusion-Based Image Generators for Monocular Depth
Estimation", CVPR 2024, arXiv 2312.02145; prs-eth/Marigold,
``marigold/marigold_pipeline.py``) for inference: a latent-diffusion depth
estimator built from Stable Diffusion 2, whose forward is a loop of
network calls. One frame takes a VAE encode, ``steps`` calls of a U-Net
denoiser with a DDIM update between them, and a VAE decode.

Module names follow diffusers' (``unet.*`` of ``UNet2DConditionModel``,
``vae.*`` of ``AutoencoderKL``, the VAE's attention as ``group_norm``,
``to_q``, ``to_k``, ``to_v``, ``to_out.0``) and ``empty_text_embed``, so a
published checkpoint (``prs-eth/marigold-v1-0``'s ``unet/`` and ``vae/``,
and the text encoder's output for the empty prompt) loads with
``strict=True``. ``VERSIONS`` holds the widths by ``--encoder`` name;
``marigold_v1_0`` is SD2's U-Net with an 8-channel ``conv_in``, SD2's KL
VAE, 10 DDIM steps at ``run.py``'s processing resolution 768.

The forward, as upstream's ``single_infer`` computes it at ensemble size 1:

- the normalized frame x in [-1, 1] (``--normalization symmetric``)
  resized so that its long edge is ``processing_res`` (bilinear,
  ``align_corners=False``, through ``ops/resize``; upstream's
  ``resize(..., antialias=True)``, which equals it when upsampling);
- ``rgb_latent = 0.18215 * mean``, ``mean`` the first ``latent`` channels
  of ``quant_conv(vae.encoder(x))``;
- z the seeded noise of the latent's shape; for each DDIM step (t,
  ab_t, ab_prev) of ``ddim_schedule``, v = ``unet(cat([rgb_latent, z]),
  t, context)`` and ``z = ddim_step(z, v, ab_t, ab_prev)``: v-prediction,
  eta 0, no clipping;
- ``d = mean_c(vae.decoder(post_quant_conv(z / 0.18215)))``, clipped to
  [-1, 1] and shifted to [0, 1], resized to the frame (PyTorch's bilinear
  with ``antialias=True``, float32), and served as ``min_depth + d *
  (max_depth - min_depth)`` metres: Marigold's map is affine-invariant in
  [0, 1], and the dataset's range gives it metres.

The VAE (SD2's ``AutoencoderKL``): ResNet blocks ``conv2(SiLU(GN(conv1(
SiLU(GN(x)))))) + shortcut(x)`` with GroupNorm(32, eps 1e-6); the encoder
a ``conv_in``, down blocks of ``layers`` ResNets each followed (but the
last) by a Downsample (pad right and bottom by one, conv 3x3 stride 2), a
mid block (ResNet, one-head attention over the h * w tokens, ResNet), GN,
SiLU, ``conv_out`` to 2 * ``latent`` moments; the decoder mirrors it with
up blocks of ``layers`` + 1 ResNets and Upsamples (nearest x2, conv 3x3).

The U-Net (SD2's ``UNet2DConditionModel``): a sinusoidal time embedding
([cos, sin] of t * exp(-ln(10000) i / half)), ``linear_1``, SiLU,
``linear_2``; ResNet blocks with the time embedding's projection added
after ``conv1`` and GroupNorm(32, eps 1e-5); Transformer blocks (GN(32,
eps 1e-6), ``proj_in``, self-attention, cross-attention to the (77,
``context_dim``) context, a GEGLU feed-forward, each behind a LayerNorm of
eps 1e-5 and added to the stream, ``proj_out``, plus the block's input);
heads of 64 at every level; down blocks of ``layers`` (ResNet,
Transformer) pairs and a Downsample (conv 3x3 stride 2), the last of
ResNets alone; a mid block (ResNet, Transformer, ResNet); up blocks of
``layers`` + 1 pairs, each ResNet reading ``cat([h, skip])`` of the last
skip pushed, an Upsample after each but the last; GN, SiLU, ``conv_out``.

The noise and the time embeddings' inputs of a shape are made once a
device, at the first forward of that shape: the noise drawn on the host
from a CPU generator seeded with ``noise_seed``, so that every batch sees
the same noise and a CUDA graph's replay (``models/graphed.py``) draws
nothing. The DDIM constants are Python numbers in the loop.

Under autocast the sampler's arithmetic, the latents and the final clip,
map and resize run in float32; GroupNorm is PyTorch's (autocast runs it in
float32). Every self- and cross-attention of the U-Net is one launch of
``ops/global_attention``'s kernel (32 a call), every LayerNorm one of
``ops/layer_norm``'s (48 a call), the frame's resize one of
``ops/resize``'s; the VAE's two one-head attentions (d = 512) are two
matrix products and a float32 softmax. ``UNET_CALLS`` counts the U-Net's
calls (``ops.LAUNCH_COUNTERS``: a replay adds those of its capture). The
spans ``marigold/encode``, ``marigold/unet`` (one a step) and
``marigold/decode`` name the parts in a profile. The forward takes
``(image, focal)`` and ignores the focal; it returns ``(depth,)``, (B, 1,
H, W) float32 (``PAD_MULTIPLE`` 1: the model resizes its frame itself),
for frames whose processed size halves cleanly down the VAE and the U-Net.
Training is not supported: the kernels have no backward.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from bts_tpu_torch.models.graphed import GraphedForward
from bts_tpu_torch.models.layers import LayerNorm, gemm_dtype, seeded_init, upsample_nearest
from bts_tpu_torch.ops import count_launches
from bts_tpu_torch.ops.global_attention import HEAD_DIM, global_attention
from bts_tpu_torch.ops.resize import bilinear

# U-Net calls that ran in this process (``ops.LAUNCH_COUNTERS``).
UNET_CALLS = 0
count_launches(__name__, "UNET_CALLS")

# --encoder names and their widths (prs-eth/marigold-v1-0's unet/config.json
# and vae/config.json, run.py's --denoise_steps and --processing_res).
VERSIONS = {
    "marigold_v1_0": dict(unet_channels=(320, 640, 1280, 1280), context_dim=1024,
                          vae_channels=(128, 256, 512, 512), layers=2, latent=4,
                          processing_res=768, steps=10, noise_seed=0),
}
GROUPS = 32  # every GroupNorm's
VAE_EPS = 1e-6  # the VAE's GroupNorms and the Transformers' input GroupNorm
UNET_EPS = 1e-5  # the U-Net ResNets' GroupNorms and the Transformers' LayerNorms
CONTEXT_TOKENS = 77  # the text encoder's sequence
LATENT_SCALE = 0.18215  # SD2's VAE scaling factor
# SD2's DDIM scheduler as Marigold keeps it: scaled_linear betas,
# "leading" spacing, steps_offset 1, set_alpha_to_one False, v-prediction.
TRAIN_STEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012
STEPS_OFFSET = 1


def processing_size(h: int, w: int, res: int) -> Tuple[int, int]:
    """The size an h x w frame is resized to (upstream's
    ``resize_max_res``): each side times min(res / w, res / h), truncated."""
    s = min(res / w, res / h)
    return int(h * s), int(w * s)


@functools.lru_cache(maxsize=None)
def ddim_schedule(steps: int) -> Tuple[Tuple[int, float, float], ...]:
    """(t, ab_t, ab_prev) of each step, in order: ``ab`` the cumulative
    product of 1 - beta over the float32 betas
    ``linspace(sqrt(0.00085), sqrt(0.012), 1000) ** 2``; t = 901, 801, ...,
    1 for 10 steps; ab_prev = ab[t - 1000 // steps], or ab[0] past the
    start."""
    betas = torch.linspace(BETA_START ** 0.5, BETA_END ** 0.5, TRAIN_STEPS,
                           dtype=torch.float32) ** 2
    ab = torch.cumprod(1.0 - betas, 0)
    ratio = TRAIN_STEPS // steps
    out = []
    for i in reversed(range(steps)):
        t = i * ratio + STEPS_OFFSET
        prev = t - ratio
        out.append((t, float(ab[t]), float(ab[prev] if prev >= 0 else ab[0])))
    return tuple(out)


def ddim_step(z: torch.Tensor, v: torch.Tensor, ab_t: float, ab_prev: float) -> torch.Tensor:
    """One DDIM update from a v-prediction at eta 0: x0 = sqrt(ab_t) z -
    sqrt(1 - ab_t) v, eps = sqrt(ab_t) v + sqrt(1 - ab_t) z, then
    sqrt(ab_prev) x0 + sqrt(1 - ab_prev) eps."""
    a, s = ab_t ** 0.5, (1.0 - ab_t) ** 0.5
    x0 = a * z - s * v
    eps = a * v + s * z
    return ab_prev ** 0.5 * x0 + (1.0 - ab_prev) ** 0.5 * eps


def timestep_embedding(t: int, dim: int, device: torch.device) -> torch.Tensor:
    """(1, dim) float32: [cos(t f), sin(t f)] with f_i = exp(-ln(10000) i /
    (dim / 2)) (diffusers' ``Timesteps`` with ``flip_sin_to_cos``, shift 0)."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32, device=device) / half
    arg = t * torch.exp(exponent)
    return torch.cat([torch.cos(arg), torch.sin(arg)])[None]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2, as the Upsamples of the VAE and the U-Net resample."""
    return upsample_nearest(x, 2)


def skip_cat(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """An up block's ResNet input: the stream, then the skip."""
    return torch.cat([h, skip], 1)


class ResnetBlock(nn.Module):
    """``conv2(SiLU(GN(conv1(SiLU(GN(x))) [+ time_emb_proj(SiLU(temb))])))``
    plus x, or ``conv_shortcut(x)`` where the channels change."""

    def __init__(self, cin: int, cout: int, eps: float, temb: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(GROUPS, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample(nn.Module):
    """Conv 3x3 stride 2: the U-Net's with padding 1, the VAE's (``pad``)
    after a zero pad of one row and column at the bottom and the right."""

    def __init__(self, channels: int, pad: bool):
        super().__init__()
        self.pad = pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.pad else x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x(x))


class Attention(nn.Module):
    """Multi-head attention of the U-Net, heads of 64: ``to_q`` of the
    stream, ``to_k`` and ``to_v`` (no bias) of the stream or of the context,
    ``to_out.0`` (with bias); through ``ops/global_attention``, the
    context's K and V expanded over the batch."""

    def __init__(self, dim: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = dim // HEAD_DIM
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        src = x if context is None else context
        q = self.to_q(x).view(b, n, self.heads, HEAD_DIM)
        k = self.to_k(src).view(src.shape[0], src.shape[1], self.heads, HEAD_DIM)
        v = self.to_v(src).view(src.shape[0], src.shape[1], self.heads, HEAD_DIM)
        k, v = k.expand(b, -1, -1, -1), v.expand(b, -1, -1, -1)
        return self.to_out[0](global_attention(q, k, v, HEAD_DIM ** -0.5))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """``net.0`` GEGLU(C, 4C), ``net.2`` Linear(4C, C) (``net.1`` is
    upstream's dropout)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """diffusers' ``BasicTransformerBlock``: self-attention, cross-attention
    to the context, GEGLU feed-forward, each behind a LayerNorm (the kernel
    on a card, writing the dtype its Linear reads) and added to the stream."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, to_gemm=True, eps=UNET_EPS)
        self.attn1 = Attention(dim)
        self.norm2 = LayerNorm(dim, to_gemm=True, eps=UNET_EPS)
        self.attn2 = Attention(dim, context_dim)
        self.norm3 = LayerNorm(dim, to_gemm=True, eps=UNET_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """diffusers' ``Transformer2DModel`` with ``use_linear_projection``: GN,
    the (B, h * w, C) tokens through ``proj_in``, one block, ``proj_out``,
    back to (B, C, h, w), plus the input."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, dim, eps=VAE_EPS)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(dim, context_dim)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            t = block(t, context)
        return x + self.proj_out(t).view(b, h, w, c).permute(0, 3, 1, 2)


class DownBlock(nn.Module):
    """``layers`` ResNets, each followed by a Transformer where ``attention``,
    then a Downsample where ``down``; returns the stream and its skips."""

    def __init__(self, cin: int, cout: int, layers: int, temb: int, context_dim: int,
                 attention: bool, down: bool):
        super().__init__()
        self.attentions = (nn.ModuleList([Transformer2D(cout, context_dim)
                                          for _ in range(layers)]) if attention else None)
        self.resnets = nn.ModuleList([ResnetBlock(cin if j == 0 else cout, cout, UNET_EPS, temb)
                                      for j in range(layers)])
        self.downsamplers = nn.ModuleList([Downsample(cout, pad=False)]) if down else None

    def forward(self, h, temb, context):
        skips = []
        for j, resnet in enumerate(self.resnets):
            h = resnet(h, temb)
            if self.attentions is not None:
                h = self.attentions[j](h, context)
            skips.append(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
            skips.append(h)
        return h, skips


class UpBlock(nn.Module):
    """``layers`` + 1 ResNets over ``skip_cat(h, skip)``, the last skip
    first, each followed by a Transformer where ``attention``; then an
    Upsample where ``up``."""

    def __init__(self, prev: int, cout: int, skip_in: int, layers: int, temb: int,
                 context_dim: int, attention: bool, up: bool):
        super().__init__()
        self.attentions = (nn.ModuleList([Transformer2D(cout, context_dim)
                                          for _ in range(layers + 1)]) if attention else None)
        self.resnets = nn.ModuleList([
            ResnetBlock((prev if j == 0 else cout) + (skip_in if j == layers else cout), cout,
                        UNET_EPS, temb) for j in range(layers + 1)])
        self.upsamplers = nn.ModuleList([Upsample(cout)]) if up else None

    def forward(self, h, skips, temb, context):
        for j, resnet in enumerate(self.resnets):
            h = resnet(skip_cat(h, skips.pop()), temb)
            if self.attentions is not None:
                h = self.attentions[j](h, context)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class MidBlock(nn.Module):
    """ResNet, attention, ResNet: the U-Net's with a Transformer, the VAE's
    with a one-head ``VAEAttention``."""

    def __init__(self, channels: int, eps: float, temb: Optional[int] = None,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attentions = nn.ModuleList([Transformer2D(channels, context_dim) if temb
                                         else VAEAttention(channels)])
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, eps, temb)
                                      for _ in range(2)])

    def forward(self, h, temb=None, context=None):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context) if temb is not None else self.attentions[0](h)
        return self.resnets[1](h, temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear_1 = nn.Linear(dim, out)
        self.linear_2 = nn.Linear(out, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    """SD2's ``UNet2DConditionModel`` (module docstring): (B, in, h, w),
    the time embedding's input (1, C0) and the context (1, 77, D) -> (B,
    out, h, w)."""

    def __init__(self, channels: Sequence[int], layers: int, context_dim: int,
                 cin: int = 8, cout: int = 4):
        super().__init__()
        last = len(channels) - 1
        temb = 4 * channels[0]
        self.conv_in = nn.Conv2d(cin, channels[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(channels[0], temb)
        self.down_blocks = nn.ModuleList([
            DownBlock(channels[max(i - 1, 0)], c, layers, temb, context_dim,
                      attention=i < last, down=i < last) for i, c in enumerate(channels)])
        self.mid_block = MidBlock(channels[-1], UNET_EPS, temb, context_dim)
        rev = list(reversed(channels))
        self.up_blocks = nn.ModuleList([
            UpBlock(rev[max(i - 1, 0)], c, rev[min(i + 1, last)], layers, temb, context_dim,
                    attention=i > 0, up=i < last) for i, c in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(GROUPS, channels[0], eps=UNET_EPS)
        self.conv_out = nn.Conv2d(channels[0], cout, 3, padding=1)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, context: torch.Tensor):
        global UNET_CALLS
        temb = self.time_embedding(t_emb)
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            h, res = block(h, temb, context)
            skips += res
        h = self.mid_block(h, temb, context)
        for block in self.up_blocks:
            h = block(h, skips, temb, context)
        UNET_CALLS += 1
        return self.conv_out(F.silu(self.conv_norm_out(h), inplace=True))


class VAEAttention(nn.Module):
    """The VAE's mid-block attention: GN, one head over the h * w tokens
    (``to_q``, ``to_k``, ``to_v`` with bias), ``to_out.0``, plus the input.
    Two matrix products in the dtype a Linear writes and a float32 softmax,
    P rounded to that dtype before P V."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(GROUPS, channels, eps=VAE_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).view(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        s = torch.bmm(q, k.transpose(1, 2))
        p = torch.softmax(s.float().mul_(c ** -0.5), dim=-1).to(v.dtype)
        o = self.to_out[0](torch.bmm(p, v))
        return x + o.transpose(1, 2).view(b, c, h, w)


class Encoder(nn.Module):
    def __init__(self, channels: Sequence[int], layers: int, latent: int):
        super().__init__()
        last = len(channels) - 1
        self.conv_in = nn.Conv2d(3, channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(channels):
            block = nn.Module()
            block.resnets = nn.ModuleList([
                ResnetBlock(channels[max(i - 1, 0)] if j == 0 else c, c, VAE_EPS)
                for j in range(layers)])
            block.downsamplers = nn.ModuleList([Downsample(c, pad=True)]) if i < last else None
            self.down_blocks.append(block)
        self.mid_block = MidBlock(channels[-1], VAE_EPS)
        self.conv_norm_out = nn.GroupNorm(GROUPS, channels[-1], eps=VAE_EPS)
        self.conv_out = nn.Conv2d(channels[-1], 2 * latent, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h), inplace=True))


class Decoder(nn.Module):
    def __init__(self, channels: Sequence[int], layers: int, latent: int):
        super().__init__()
        last = len(channels) - 1
        rev = list(reversed(channels))
        self.conv_in = nn.Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], VAE_EPS)
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList([
                ResnetBlock(rev[max(i - 1, 0)] if j == 0 else c, c, VAE_EPS)
                for j in range(layers + 1)])
            block.upsamplers = nn.ModuleList([Upsample(c)]) if i < last else None
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(GROUPS, channels[0], eps=VAE_EPS)
        self.conv_out = nn.Conv2d(channels[0], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if block.upsamplers is not None:
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h), inplace=True))


class AutoencoderKL(nn.Module):
    def __init__(self, channels: Sequence[int], layers: int, latent: int):
        super().__init__()
        self.encoder = Encoder(channels, layers, latent)
        self.decoder = Decoder(channels, layers, latent)
        self.quant_conv = nn.Conv2d(2 * latent, 2 * latent, 1)
        self.post_quant_conv = nn.Conv2d(latent, latent, 1)


class MarigoldModel(GraphedForward):
    """image (B, 3, H, W) in [-1, 1], focal (B,) (ignored) -> (depth,), (B,
    1, H, W) float32 in [min_depth, max_depth]. The widths default to
    ``marigold_v1_0``."""

    OUTPUTS = ("depth",)
    TRAINS = False
    PAD_MULTIPLE = 1  # the forward resizes its frame itself
    NORMALIZATION = "symmetric"  # upstream's rgb / 255 * 2 - 1

    def __init__(self, max_depth: float = 10.0, min_depth: float = 1e-3,
                 unet_channels: Sequence[int] = (320, 640, 1280, 1280), context_dim: int = 1024,
                 vae_channels: Sequence[int] = (128, 256, 512, 512), layers: int = 2,
                 latent: int = 4, processing_res: int = 768, steps: int = 10,
                 noise_seed: int = 0):
        super().__init__()
        self.max_depth, self.min_depth = float(max_depth), float(min_depth)
        self.processing_res, self.steps, self.noise_seed = processing_res, steps, noise_seed
        # the processed frame's sides are multiples of this
        self.multiple = 2 ** (len(vae_channels) - 1 + len(unet_channels) - 1)
        self.unet = UNet(unet_channels, layers, context_dim, cin=2 * latent, cout=latent)
        self.vae = AutoencoderKL(vae_channels, layers, latent)
        self.empty_text_embed = nn.Parameter(torch.zeros(CONTEXT_TOKENS, context_dim))
        self._constants = {}  # (latent shape, device) -> (noise, *time-embedding inputs)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The RGB latent, float32: 0.18215 times the moments' mean."""
        moments = self.vae.quant_conv(self.vae.encoder(x))
        return LATENT_SCALE * moments[:, :moments.shape[1] // 2].float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """The decoder's output averaged over its channels, float32."""
        out = self.vae.decoder(self.vae.post_quant_conv(z / LATENT_SCALE))
        return out.float().mean(1, keepdim=True)

    def constants(self, shape: torch.Size, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The seeded noise of a latent ``shape``, then each step's
        time-embedding input, on ``device``; made at the first call."""
        key = (tuple(shape), device, self.noise_seed, self.steps)
        if key not in self._constants:
            gen = torch.Generator().manual_seed(self.noise_seed)
            noise = torch.randn(tuple(shape), generator=gen, dtype=torch.float32).to(device)
            width = self.unet.time_embedding.linear_1.in_features
            self._constants[key] = (noise, *(timestep_embedding(t, width, device)
                                             for t, _, _ in ddim_schedule(self.steps)))
        return self._constants[key]

    def _forward(self, x: torch.Tensor, focal: torch.Tensor) -> Tuple[torch.Tensor]:
        h, w = x.shape[-2:]
        ph, pw = processing_size(h, w, self.processing_res)
        if ph % self.multiple or pw % self.multiple:
            raise ValueError(f"Marigold processes a {h}x{w} frame at {ph}x{pw}, which does not "
                             f"halve cleanly down the VAE and the U-Net (multiples of "
                             f"{self.multiple})")
        with record_function("marigold/encode"):
            if (ph, pw) != (h, w):
                x = bilinear(x, (ph, pw), False, gemm_dtype(x))
            rgb_latent = self.encode(x)
        z, *temb = self.constants(rgb_latent.shape, x.device)
        context = self.empty_text_embed[None]
        for (_, ab_t, ab_prev), t_emb in zip(ddim_schedule(self.steps), temb):
            with record_function("marigold/unet"):
                v = self.unet(torch.cat([rgb_latent, z], 1), t_emb, context)
                z = ddim_step(z, v.float(), ab_t, ab_prev)
        with record_function("marigold/decode"):
            d = self.decode(z)
            with torch.autocast(d.device.type, enabled=False):
                d = (d.clamp(-1.0, 1.0) + 1.0) / 2.0
                d = F.interpolate(d, (h, w), mode="bilinear", align_corners=False,
                                  antialias=True)
                depth = self.min_depth + d * (self.max_depth - self.min_depth)
        return (depth,)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init from the CPU ``generator`` (``layers.seeded_init``):
    Xavier-uniform convolutions and linear layers, biases 0, norms at
    identity, the empty-text embedding a normal of std 0.02 truncated at
    +-2."""
    return seeded_init(model, generator, normal=("empty_text_embed",))


def create_model(cfg) -> MarigoldModel:
    """``MarigoldModel`` of ``cfg.encoder``'s widths (``VERSIONS``) over
    [``cfg.min_depth``, ``cfg.max_depth``], on the CPU, its weights seeded
    from ``cfg.seed``. There is no TF graph of it."""
    if cfg.resolved_flavor != "pt":
        raise ValueError(f"--encoder {cfg.encoder} (Marigold) has no TF graph "
                         f"(model_flavor {cfg.resolved_flavor!r})")
    model = MarigoldModel(max_depth=cfg.max_depth, min_depth=cfg.min_depth,
                          **VERSIONS[cfg.encoder])
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))

