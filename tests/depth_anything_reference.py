"""The CPU tests' plain float32 reference of Depth Anything V2, metric
(Yang et al., NeurIPS 2024, arXiv 2406.09414; DepthAnything/
Depth-Anything-V2, ``metric_depth/depth_anything_v2/dpt.py``,
``dinov2.py``, ``util/blocks.py``, ``util/transform.py``), written from
upstream's equations with nothing of the program (the benchmark keeps its
own copy, ``benchmark/reference/depth_anything.py``, with the float8
control's hooks): the frame resized to the model's input, a DINOv2 ViT
(patch embedding, class token, bicubically resized position table,
pre-norm blocks with LayerScale, global attention, a GELU MLP), its four
tapped blocks normed into a DPT head (projections, resizes, fusion blocks
of residual units), a sigmoid times ``max_depth``, resized back to the
frame.

Module names are upstream's, and so the program's, but one: the LayerScale
vector is ``ls1.weight`` and ``ls2.weight`` here, where upstream and the
program name it ``gamma``, so that ``weights.py`` seeds it at one (a 1-D
``weight``), upstream's ``init_values`` 1.0; as any other learned tensor it
would be drawn at std 0.02 and shrink every residual branch to about 2%,
which would hide the attention from the check. The tests map the two
names.

Attention is computed for blocks of at most ``ATTENTION_ROWS`` queries
against all keys, with the exact softmax of each whole row: no online
softmax, so nothing of the kernel's method, and a batch of 8 KITTI images
(4,737 tokens) fits a card in float32.

The configuration gives the widths: ``vit`` (``embed_dim``, ``depth``,
``num_heads``, ``mlp_ratio``, ``patch_size``, ``pos_grid``,
``interpolate_offset``, ``layer_norm_eps``, ``taps``), ``dpt``
(``features``, ``out_channels``, ``head_hidden``), ``input_size`` and
``max_depth``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ATTENTION_ROWS = 1024  # queries a block of the attention


Conv, ConvTranspose, Linear = nn.Conv2d, nn.ConvTranspose2d, nn.Linear


def resized(h, w, size, multiple):
    """Upstream's ``Resize(size, size, keep_aspect_ratio=True,
    ensure_multiple_of=multiple, resize_method='lower_bound')``: the output
    (height, width)."""
    scale = max(size / h, size / w)

    def constrain(x):
        y = int(np.round(x / multiple) * multiple)
        if y < size:
            y = int(np.ceil(x / multiple) * multiple)
        return y

    return constrain(scale * h), constrain(scale * w)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.weight


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * self.scale
        out = []
        for r in range(0, n, ATTENTION_ROWS):
            attn = (q[:, :, r:r + ATTENTION_ROWS] @ k.transpose(-2, -1)).softmax(dim=-1)
            out.append(attn @ v)
        x = torch.cat(out, 2).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = Conv(3, dim, kernel_size=patch, stride=patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, vit):
        super().__init__()
        dim, grid = vit["embed_dim"], vit["pos_grid"]
        self.patch_size, self.offset = vit["patch_size"], vit["interpolate_offset"]
        self.patch_embed = PatchEmbed(self.patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList([Block(dim, vit["num_heads"], vit["mlp_ratio"],
                                           vit["layer_norm_eps"]) for _ in range(vit["depth"])])
        self.norm = nn.LayerNorm(dim, eps=vit["layer_norm_eps"])
        self.mask_token = nn.Parameter(torch.zeros(1, dim))

    def interpolate_pos_encoding(self, x, height, width):
        """Upstream's: the table as it is for a square input of the table's
        grid, else its grid resized bicubically by scale factors."""
        npatch, n = x.shape[1] - 1, self.pos_embed.shape[1] - 1
        if npatch == n and height == width:
            return self.pos_embed
        pos_embed = self.pos_embed.float()
        dim = x.shape[-1]
        h0 = height // self.patch_size + self.offset
        w0 = width // self.patch_size + self.offset
        side = math.sqrt(n)
        patch_pos = F.interpolate(
            pos_embed[:, 1:].reshape(1, int(side), int(side), dim).permute(0, 3, 1, 2),
            scale_factor=(h0 / side, w0 / side), mode="bicubic", antialias=False)
        assert (int(h0), int(w0)) == tuple(patch_pos.shape[-2:])
        patch_pos = patch_pos.permute(0, 2, 3, 1).view(1, -1, dim)
        return torch.cat((pos_embed[:, :1], patch_pos), dim=1).to(x.dtype)

    def get_intermediate_layers(self, x, taps):
        height, width = x.shape[-2:]
        x = self.patch_embed(x)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        x = x + self.interpolate_pos_encoding(x, height, width)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in taps:
                outs.append(x)
        return [self.norm(o)[:, 1:] for o in outs]


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.conv2 = Conv(features, features, kernel_size=3, stride=1, padding=1, bias=True)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.out_conv = Conv(features, features, kernel_size=1, stride=1, padding=0, bias=True)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs, size=None):
        output = xs[0]
        if len(xs) == 2:
            output = output + self.resConfUnit1(xs[1])
        output = self.resConfUnit2(output)
        modifier = {"scale_factor": 2} if size is None else {"size": size}
        output = F.interpolate(output, **modifier, mode="bilinear", align_corners=True)
        return self.out_conv(output)


class DPTHead(nn.Module):
    def __init__(self, in_channels, dpt):
        super().__init__()
        features, out_channels = dpt["features"], dpt["out_channels"]
        self.projects = nn.ModuleList([
            Conv(in_channels, c, kernel_size=1, stride=1, padding=0) for c in out_channels])
        self.resize_layers = nn.ModuleList([
            ConvTranspose(out_channels[0], out_channels[0], kernel_size=4, stride=4, padding=0),
            ConvTranspose(out_channels[1], out_channels[1], kernel_size=2, stride=2, padding=0),
            nn.Identity(),
            Conv(out_channels[3], out_channels[3], kernel_size=3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, c in enumerate(out_channels):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    Conv(c, features, kernel_size=3, stride=1, padding=1, bias=False))
        for i in range(4):
            setattr(self.scratch, f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.scratch.output_conv1 = Conv(features, features // 2, kernel_size=3, stride=1,
                                         padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            Conv(features // 2, dpt["head_hidden"], kernel_size=3, stride=1, padding=1),
            nn.ReLU(True),
            Conv(dpt["head_hidden"], 1, kernel_size=1, stride=1, padding=0),
            nn.Sigmoid())

    def forward(self, out_features, patch_h, patch_w, patch):
        out = []
        for i, x in enumerate(out_features):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], patch_h, patch_w)
            out.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        layer_1_rn, layer_2_rn, layer_3_rn, layer_4_rn = (
            getattr(s, f"layer{i + 1}_rn")(o) for i, o in enumerate(out))
        path_4 = s.refinenet4(layer_4_rn, size=layer_3_rn.shape[2:])
        path_3 = s.refinenet3(path_4, layer_3_rn, size=layer_2_rn.shape[2:])
        path_2 = s.refinenet2(path_3, layer_2_rn, size=layer_1_rn.shape[2:])
        path_1 = s.refinenet1(path_2, layer_1_rn)
        out = s.output_conv1(path_1)
        out = F.interpolate(out, (int(patch_h * patch), int(patch_w * patch)), mode="bilinear",
                            align_corners=True)
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """image (B, 3, H, W), normalized, focal (B,) (not used, as upstream's)
    -> depth (B, 1, H, W)."""

    def __init__(self, config: dict):
        super().__init__()
        self.vit, self.dpt = config["vit"], config["dpt"]
        self.input_size, self.max_depth = config["input_size"], config["max_depth"]
        self.pretrained = DinoVisionTransformer(self.vit)
        self.depth_head = DPTHead(self.vit["embed_dim"], self.dpt)

    def forward(self, image, focal):
        h, w = image.shape[-2:]
        patch = self.vit["patch_size"]
        x = F.interpolate(image, resized(h, w, self.input_size, patch), mode="bicubic",
                          align_corners=False)
        patch_h, patch_w = x.shape[-2] // patch, x.shape[-1] // patch
        features = self.pretrained.get_intermediate_layers(x, self.vit["taps"])
        depth = self.depth_head(features, patch_h, patch_w, patch) * self.max_depth
        return F.interpolate(depth, (h, w), mode="bilinear", align_corners=True)
