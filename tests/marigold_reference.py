"""The CPU tests' plain float32 reference of Marigold v1-0 (Ke et al., CVPR 2024,
arXiv 2312.02145; prs-eth/Marigold ``marigold/marigold_pipeline.py``,
``single_infer`` at ensemble size 1, with diffusers' ``UNet2DConditionModel``,
``AutoencoderKL`` and ``DDIMScheduler`` as Stable Diffusion 2 configures
them), written from upstream's equations with nothing of the program (the
benchmark keeps its own copy, ``benchmark/reference/marigold.py``):

- the frame resized so that its long edge is ``processing_res`` (bilinear
  with ``antialias=True``, upstream's ``resize_max_res``);
- the VAE encoder (ResNet blocks of GroupNorm(32, eps 1e-6), SiLU and 3x3
  convolutions, Downsamples that pad right and bottom by one before a
  stride-2 convolution, a mid block with one-head attention), ``quant_conv``
  and the first half of the moments times 0.18215;
- the DDIM loop: noise drawn on the host from ``noise_seed``, the U-Net
  called on ``cat([rgb_latent, z])`` at each of the scheduler's timesteps
  (``leading`` spacing, ``steps_offset`` 1), its output read as v, and
  diffusers' ``DDIMScheduler.step`` at eta 0 with ``set_alpha_to_one``
  False;
- the U-Net: the sinusoidal time embedding (cos first), ResNet blocks with
  the time projection, Transformer blocks (GroupNorm, ``proj_in``,
  self-attention, cross-attention to the empty-text embedding, GEGLU,
  LayerNorms, ``proj_out``), skips concatenated after the stream;
- the VAE decoder (nearest-x2 Upsamples), the channel mean, the clip to
  [-1, 1], the shift to [0, 1], the resize back (bilinear,
  ``antialias=True``), and ``min_depth + d * (max_depth - min_depth)``.

Module names are diffusers' and the program's. Attention is computed for
blocks of at most ``ATTENTION_ROWS`` queries against all keys, with the
exact softmax of each whole row, so that a batch of 8 frames at 576x768
(6,912 latent tokens, five heads) fits a card in float32. Every convolution
and linear layer has a ``quant`` attribute (None), which the
benchmark's float8 control sets.

The configuration gives the widths: ``unet`` (``block_out_channels``,
``layers_per_block``, ``attention_head_dim`` (heads a level),
``cross_attention_dim``, ``in_channels``, ``out_channels``), ``vae``
(``block_out_channels``, ``layers_per_block``, ``latent_channels``,
``scaling_factor``), ``scheduler`` (``num_train_timesteps``,
``beta_start``, ``beta_end``, ``steps_offset``), ``denoise_steps``,
``processing_res``, ``noise_seed``, ``min_depth`` and ``max_depth``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ATTENTION_ROWS = 1024  # queries a block of the attention
TEXT_TOKENS = 77


class Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        return self._conv_forward(self.quant(x), self.quant(self.weight), self.bias)


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        return F.linear(self.quant(x), self.quant(self.weight), self.bias)


def attention(q, k, v, scale):
    """softmax(q k^T * scale) v over (..., N_q, d) and (..., N_k, d), in
    blocks of queries."""
    out = []
    for r in range(0, q.shape[-2], ATTENTION_ROWS):
        s = (q[..., r:r + ATTENTION_ROWS, :] @ k.transpose(-2, -1)) * scale
        out.append(s.softmax(dim=-1) @ v)
    return torch.cat(out, -2)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, eps, temb_channels=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels, padding):
        super().__init__()
        self.padding = padding
        self.conv = Conv(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1), mode="constant", value=0)
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, context_dim=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim or dim, dim, bias=False)
        self.to_v = Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, c = x.shape
        d = c // self.heads

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, d).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(context)), split(self.to_v(context))
        o = attention(q, k, v, d ** -0.5).transpose(1, 2).reshape(b, n, c)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Dropout(0.0), Linear(4 * dim, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(dim, heads, context_dim)])
        self.proj_out = Linear(dim, dim)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context)
        x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return x + residual


class UNetBlock(nn.Module):
    """A down or up block of the U-Net: resnets, optional attentions, and a
    resampler (``downsamplers`` or ``upsamplers``)."""

    def __init__(self, resnets, attentions, sampler_name, sampler):
        super().__init__()
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, heads = cfg["block_out_channels"], cfg["attention_head_dim"]
        layers, ctx = cfg["layers_per_block"], cfg["cross_attention_dim"]
        temb = ch[0] * 4
        last = len(ch) - 1
        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(ch[0], temb)
        self.time_embedding.linear_2 = Linear(temb, temb)
        self.down_blocks = nn.ModuleList()
        out = ch[0]
        for i in range(len(ch)):
            cin, out = out, ch[i]
            resnets = [ResnetBlock2D(cin if j == 0 else out, out, 1e-5, temb)
                       for j in range(layers)]
            attentions = ([Transformer2DModel(out, heads[i], ctx) for _ in range(layers)]
                          if i < last else [])
            down = Downsample2D(out, padding=1) if i < last else None
            self.down_blocks.append(UNetBlock(resnets, attentions, "downsamplers", down))
        self.mid_block = nn.Module()
        self.mid_block.attentions = nn.ModuleList([Transformer2DModel(ch[-1], heads[-1], ctx)])
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(ch[-1], ch[-1], 1e-5, temb)
                                                for _ in range(2)])
        rch, rheads = list(reversed(ch)), list(reversed(heads))
        self.up_blocks = nn.ModuleList()
        prev = rch[0]
        for i in range(len(ch)):
            out, skip_in = rch[i], rch[min(i + 1, last)]
            resnets = []
            for j in range(layers + 1):
                res_skip = skip_in if j == layers else out
                resnets.append(ResnetBlock2D((prev if j == 0 else out) + res_skip, out, 1e-5,
                                             temb))
            attentions = ([Transformer2DModel(out, rheads[i], ctx) for _ in range(layers + 1)]
                          if i > 0 else [])
            up = Upsample2D(out) if i < last else None
            self.up_blocks.append(UNetBlock(resnets, attentions, "upsamplers", up))
            prev = out
        self.conv_norm_out = nn.GroupNorm(32, ch[0], eps=1e-5)
        self.conv_out = Conv(ch[0], cfg["out_channels"], 3, padding=1)

    def time_proj(self, timesteps, dim):
        half = dim // 2
        exponent = -math.log(10000) * torch.arange(0, half, dtype=torch.float32,
                                                   device=timesteps.device)
        exponent = exponent / half
        emb = timesteps[:, None].float() * torch.exp(exponent)[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        return torch.cat([emb[:, half:], emb[:, :half]], dim=-1)  # flip_sin_to_cos

    def forward(self, sample, timesteps, context):
        t_emb = self.time_proj(timesteps, self.time_embedding.linear_1.in_features)
        emb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(t_emb)))
        sample = self.conv_in(sample)
        res = [sample]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                sample = resnet(sample, emb)
                if hasattr(block, "attentions"):
                    sample = block.attentions[j](sample, context)
                res.append(sample)
            if hasattr(block, "downsamplers"):
                sample = block.downsamplers[0](sample)
                res.append(sample)
        sample = self.mid_block.resnets[0](sample, emb)
        sample = self.mid_block.attentions[0](sample, context)
        sample = self.mid_block.resnets[1](sample, emb)
        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                sample = resnet(torch.cat([sample, res.pop()], dim=1), emb)
                if hasattr(block, "attentions"):
                    sample = block.attentions[j](sample, context)
            if hasattr(block, "upsamplers"):
                sample = block.upsamplers[0](sample)
        return self.conv_out(F.silu(self.conv_norm_out(sample)))


class VAEAttention(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        o = attention(self.to_q(t), self.to_k(t), self.to_v(t), c ** -0.5)
        return self.to_out[0](o).transpose(1, 2).reshape(b, c, h, w) + x


def vae_mid_block(channels):
    mid = nn.Module()
    mid.attentions = nn.ModuleList([VAEAttention(channels)])
    mid.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, 1e-6) for _ in range(2)])
    return mid


def run_vae_mid(mid, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class VAEEncoder(nn.Module):
    def __init__(self, ch, layers, latent):
        super().__init__()
        self.conv_in = Conv(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        out = ch[0]
        for i in range(len(ch)):
            cin, out = out, ch[i]
            block = nn.Module()
            block.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else out, out, 1e-6)
                                           for j in range(layers)])
            if i < len(ch) - 1:
                block.downsamplers = nn.ModuleList([Downsample2D(out, padding=0)])
            self.down_blocks.append(block)
        self.mid_block = vae_mid_block(ch[-1])
        self.conv_norm_out = nn.GroupNorm(32, ch[-1], eps=1e-6)
        self.conv_out = Conv(ch[-1], 2 * latent, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = run_vae_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, ch, layers, latent):
        super().__init__()
        rch = list(reversed(ch))
        self.conv_in = Conv(latent, rch[0], 3, padding=1)
        self.mid_block = vae_mid_block(rch[0])
        self.up_blocks = nn.ModuleList()
        out = rch[0]
        for i in range(len(ch)):
            cin, out = out, rch[i]
            block = nn.Module()
            block.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else out, out, 1e-6)
                                           for j in range(layers + 1)])
            if i < len(ch) - 1:
                block.upsamplers = nn.ModuleList([Upsample2D(out)])
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(32, ch[0], eps=1e-6)
        self.conv_out = Conv(ch[0], 3, 3, padding=1)

    def forward(self, z):
        x = run_vae_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, layers, latent = (cfg["block_out_channels"], cfg["layers_per_block"],
                              cfg["latent_channels"])
        self.encoder = VAEEncoder(ch, layers, latent)
        self.decoder = VAEDecoder(ch, layers, latent)
        self.quant_conv = Conv(2 * latent, 2 * latent, 1)
        self.post_quant_conv = Conv(latent, latent, 1)


def resize_max_res(h, w, max_edge):
    """upstream's ``resize_max_res``: the (height, width) of the resize."""
    factor = min(max_edge / w, max_edge / h)
    return int(h * factor), int(w * factor)


def ddim_timesteps(cfg, steps):
    """The scheduler's timesteps, ``leading`` spacing, and its cumulative
    alphas (float32)."""
    s = cfg["scheduler"]
    betas = torch.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                           s["num_train_timesteps"], dtype=torch.float32) ** 2
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    ratio = s["num_train_timesteps"] // steps
    timesteps = [i * ratio + s["steps_offset"] for i in reversed(range(steps))]
    return timesteps, alphas_cumprod, ratio


class Marigold(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet2DConditionModel(cfg["unet"])
        self.vae = AutoencoderKL(cfg["vae"])
        self.empty_text_embed = nn.Parameter(torch.zeros(TEXT_TOKENS,
                                                         cfg["unet"]["cross_attention_dim"]))

    def forward(self, image, focal):
        cfg = self.cfg
        scale = cfg["vae"]["scaling_factor"]
        b, _, h, w = image.shape
        size = resize_max_res(h, w, cfg["processing_res"])
        rgb = F.interpolate(image, size, mode="bilinear", align_corners=False, antialias=True)
        moments = self.vae.quant_conv(self.vae.encoder(rgb))
        mean, _logvar = torch.chunk(moments, 2, dim=1)
        rgb_latent = mean * scale
        gen = torch.Generator().manual_seed(cfg["noise_seed"])
        latent = torch.randn(rgb_latent.shape, generator=gen, dtype=torch.float32,
                             device="cpu").to(image.device)
        context = self.empty_text_embed[None].repeat(b, 1, 1)
        timesteps, alphas_cumprod, ratio = ddim_timesteps(cfg, cfg["denoise_steps"])
        for t in timesteps:
            v = self.unet(torch.cat([rgb_latent, latent], dim=1),
                          torch.full((b,), t, dtype=torch.int64, device=image.device), context)
            prev = t - ratio
            alpha_prod_t = float(alphas_cumprod[t])
            alpha_prod_t_prev = float(alphas_cumprod[prev] if prev >= 0 else alphas_cumprod[0])
            beta_prod_t = 1 - alpha_prod_t
            pred_original = alpha_prod_t ** 0.5 * latent - beta_prod_t ** 0.5 * v
            pred_epsilon = alpha_prod_t ** 0.5 * v + beta_prod_t ** 0.5 * latent
            direction = (1 - alpha_prod_t_prev) ** 0.5 * pred_epsilon
            latent = alpha_prod_t_prev ** 0.5 * pred_original + direction
        z = self.vae.post_quant_conv(latent / scale)
        depth = self.vae.decoder(z).mean(dim=1, keepdim=True)
        depth = (torch.clip(depth, -1.0, 1.0) + 1.0) / 2.0
        depth = F.interpolate(depth, (h, w), mode="bilinear", align_corners=False,
                              antialias=True)
        return cfg["min_depth"] + depth * (cfg["max_depth"] - cfg["min_depth"])
