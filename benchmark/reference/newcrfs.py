"""The plain float32 reference of NeWCRFs (Yuan et al., CVPR 2022;
aliyun/NeWCRFs, ``newcrfs/networks/NewCRFDepth.py``, ``newcrf_layers.py``,
``swin_transformer.py``, ``uper_crf_head.py``), written from upstream's
equations with nothing of the program: a Swin backbone (shifted windows,
relative-position bias, patch merging, a LayerNorm on each of four outputs),
a pyramid-pooling head, four window-attention CRF levels and a sigmoid depth
head. Module names are upstream's, and so the program's.

Upstream's layers as they run in eval: drop-path and dropout are identity;
upstream's ``PPM`` takes GroupNorm(256 groups) for pool scale 1 and, as its
loop reassigns ``norm_cfg``, for every later scale; the bottleneck takes
BatchNorm. Every convolution and linear layer has a ``quant`` attribute
(None), which the float8 control sets (``lowp.py``).

The configuration gives the widths: ``backbone`` (``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``, ``patch_size``) and
``decoder`` (``pool_scales``, ``channels``, ``ppm_groups``, ``crf_dims``,
``crf_heads``, ``v_dims``, ``crf_window``, ``crf_depth``), and ``max_depth``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attention_mask(h, w, ws, shift, device):
    """Swin's mask of the shifted windows over the padded Hp x Wp map."""
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    img_mask = torch.zeros((1, hp, wp, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Attention(nn.Module):
    """The relative-position bias and the masked softmax of both kinds of
    window attention."""

    def __init__(self, dim, ws, num_heads):
        super().__init__()
        self.ws, self.num_heads = ws, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                            indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += ws - 1
        relative_coords[:, :, 1] += ws - 1
        relative_coords[:, :, 0] *= 2 * ws - 1
        self.register_buffer("relative_position_index", relative_coords.sum(-1))

    def attend(self, q, k, v, mask):
        """q, k, v (B_, heads, N, d) -> (B_, N, heads * d)."""
        b_, _, n, _ = q.shape
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)].view(
            n, n, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.num_heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = attn.softmax(-1)
        return (attn @ v).transpose(1, 2).reshape(b_, n, -1)


class WindowAttention(_Attention):
    def __init__(self, dim, ws, num_heads):
        super().__init__(dim, ws, num_heads)
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return self.proj(self.attend(q, k, v, mask))


class CRFAttention(_Attention):
    """Q and K from x, V from the prediction v."""

    def __init__(self, dim, ws, num_heads):
        super().__init__(dim, ws, num_heads)
        self.qk = Linear(dim, dim * 2)
        self.proj = Linear(dim, dim)

    def forward(self, x, v, mask=None):
        b_, n, c = x.shape
        q, k = self.qk(x).reshape(b_, n, 2, self.num_heads, c // self.num_heads).permute(
            2, 0, 3, 1, 4)
        v = v.view(b_, n, self.num_heads, -1).transpose(1, 2)
        return self.proj(self.attend(q, k, v, mask))


def _shifted_windows(t, ws, shift):
    """(B, H, W, C) padded to window multiples, rolled, windowed."""
    h, w = t.shape[1:3]
    t = F.pad(t, (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))
    if shift:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
    return window_partition(t, ws).view(-1, ws * ws, t.shape[-1]), t.shape[1], t.shape[2]


def _merge_windows(windows, ws, hp, wp, shift, h, w):
    x = window_reverse(windows.view(-1, ws, ws, windows.shape[-1]), ws, hp, wp)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x[:, :h, :w, :].contiguous().view(x.shape[0], h * w, -1)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, shift, mlp_ratio):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, h, w, mask):
        b, _, c = x.shape
        windows, hp, wp = _shifted_windows(self.norm1(x).view(b, h, w, c), self.ws, self.shift)
        y = self.attn(windows, mask if self.shift else None)
        x = x + _merge_windows(y, self.ws, hp, wp, self.shift, h, w)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x, h, w):
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 == 1 or w % 2 == 1:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :],
                       x[:, 1::2, 1::2, :]], -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, ws, mlp_ratio, downsample):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, ws, 0 if i % 2 == 0 else ws // 2, mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, h, w):
        mask = attention_mask(h, w, self.ws, self.ws // 2, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, mask)
        if self.downsample is None:
            return x, x, h, w
        return x, self.downsample(x, h, w), (h + 1) // 2, (w + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, patch, embed_dim):
        super().__init__()
        self.patch = patch
        self.proj = Conv(3, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        h, w = x.shape[2:]
        if w % self.patch:
            x = F.pad(x, (0, self.patch - w % self.patch))
        if h % self.patch:
            x = F.pad(x, (0, 0, 0, self.patch - h % self.patch))
        return self.proj(x)


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim, depths, num_heads, window_size, mlp_ratio, patch_size):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.num_features = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList([
            BasicLayer(self.num_features[i], depths[i], num_heads[i], window_size, mlp_ratio,
                       i < len(depths) - 1) for i in range(len(depths))])
        for i, c in enumerate(self.num_features):
            self.add_module(f"norm{i}", nn.LayerNorm(c))

    def forward(self, x):
        x = self.patch_embed(x)
        h, w = x.shape[2:]
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x, nh, nw = layer(x, h, w)
            x_out = getattr(self, f"norm{i}")(x_out)
            outs.append(x_out.view(-1, h, w, self.num_features[i]).permute(0, 3, 1, 2)
                        .contiguous())
            h, w = nh, nw
        return outs


class CRFBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = CRFAttention(dim, ws, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, v, h, w, mask):
        b, _, c = x.shape
        x_windows, hp, wp = _shifted_windows(self.norm1(x).view(b, h, w, c), self.ws, self.shift)
        v_windows, _, _ = _shifted_windows(v, self.ws, self.shift)
        y = self.attn(x_windows, v_windows, mask if self.shift else None)
        x = x + _merge_windows(y, self.ws, hp, wp, self.shift, h, w)
        return x + self.mlp(self.norm2(x))


class BasicCRFLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, ws):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList([CRFBlock(dim, num_heads, ws, 0 if i % 2 == 0 else ws // 2)
                                     for i in range(depth)])

    def forward(self, x, v, h, w):
        mask = attention_mask(h, w, self.ws, self.ws // 2, x.device)
        for blk in self.blocks:
            x = blk(x, v, h, w, mask)
        return x


class NewCRF(nn.Module):
    def __init__(self, input_dim, embed_dim, v_dim, ws, num_heads, depth):
        super().__init__()
        self.embed_dim = embed_dim
        self.proj_x = Conv(input_dim, embed_dim, 3, padding=1) if input_dim != embed_dim else None
        self.proj_v = Conv(v_dim, embed_dim, 3, padding=1) if v_dim != embed_dim else None
        self.crf_layer = BasicCRFLayer(embed_dim, depth, num_heads, ws)
        self.norm_crf = nn.LayerNorm(embed_dim)

    def forward(self, x, v):
        if self.proj_x is not None:
            x = self.proj_x(x)
        if self.proj_v is not None:
            v = self.proj_v(v)
        h, w = x.shape[2:]
        x = self.crf_layer(x.flatten(2).transpose(1, 2), v.transpose(1, 2).transpose(2, 3), h, w)
        return self.norm_crf(x).view(-1, h, w, self.embed_dim).permute(0, 3, 1, 2).contiguous()


class ConvModule(nn.Module):
    """mmcv's ConvModule: a convolution without bias, ``bn`` or ``gn``, ReLU."""

    def __init__(self, cin, cout, kernel, groups=0):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.norm_name = "gn" if groups else "bn"
        self.add_module(self.norm_name, nn.GroupNorm(groups, cout) if groups
                        else nn.BatchNorm2d(cout))

    def forward(self, x):
        return F.relu(getattr(self, self.norm_name)(self.conv(x)))


class PSP(nn.Module):
    def __init__(self, in_channels, channels, pool_scales, groups):
        super().__init__()
        self.psp_modules = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(in_channels, channels, 1, groups))
            for s in pool_scales])
        self.bottleneck = ConvModule(in_channels + len(pool_scales) * channels, channels, 3)

    def forward(self, inputs):
        x = inputs[-1]
        outs = [x] + [F.interpolate(ppm(x), size=x.shape[2:], mode="bilinear",
                                    align_corners=False) for ppm in self.psp_modules]
        return self.bottleneck(torch.cat(outs, dim=1))


class DispHead(nn.Module):
    def __init__(self, input_dim):
        super().__init__()
        self.conv1 = Conv(input_dim, 1, 3, padding=1)

    def forward(self, x, scale):
        x = torch.sigmoid(self.conv1(x))
        return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


class NeWCRFs(nn.Module):
    """image (B, 3, H, W), focal (B,) (not used, as upstream's) -> depth
    (B, 1, H, W)."""

    def __init__(self, config: dict):
        super().__init__()
        bb, dec = config["backbone"], config["decoder"]
        self.max_depth = config["max_depth"]
        self.backbone = SwinTransformer(bb["embed_dim"], bb["depths"], bb["num_heads"],
                                        bb["window_size"], bb["mlp_ratio"], bb["patch_size"])
        feats = self.backbone.num_features
        for i in (3, 2, 1, 0):
            self.add_module(f"crf{i}", NewCRF(feats[i], dec["crf_dims"][i], dec["v_dims"][i],
                                              dec["crf_window"], dec["crf_heads"][i],
                                              dec["crf_depth"]))
        self.decoder = PSP(feats[3], dec["channels"], dec["pool_scales"], dec["ppm_groups"])
        self.disp_head1 = DispHead(dec["crf_dims"][0])

    def forward(self, image, focal):
        feats = self.backbone(image)
        ppm_out = self.decoder(feats)
        e3 = F.pixel_shuffle(self.crf3(feats[3], ppm_out), 2)
        e2 = F.pixel_shuffle(self.crf2(feats[2], e3), 2)
        e1 = F.pixel_shuffle(self.crf1(feats[1], e2), 2)
        e0 = self.crf0(feats[0], e1)
        return self.disp_head1(e0, 4) * self.max_depth
