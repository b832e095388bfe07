"""A toy depth model for the harness's own tests, kept as a model file is
(the contract in ``models/bts.py``): not BTS, and of no program. A conv
stem cuts 4x4 patches, a fixed sinusoidal position table (a floating buffer
it computes) is added to each 8x8 window of patches, and a LayerNorm and one
windowed softmax attention (a ``Linear`` qkv projection, a
relative-position-bias table indexed by an integer buffer, no output
projection) act on them; a conv head gives the depth. Its program side is
the reference itself, its forward's result put in a list.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

CONFIG = {
    "name": "toy-window-attention", "model": "toy", "dataset": "nyu", "max_depth": 10.0,
    "focal": 518.8579, "normalization": "imagenet", "input_height": 64, "input_width": 96,
    "compute_dtype": "float32", "embed_dim": 32, "heads": 4, "patch": 4, "window": 8,
}
KEYS = ("embed_dim", "heads", "patch", "window", "max_depth")


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


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.scale = heads, (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        side = 2 * window - 1
        self.relative_position_bias_table = nn.Parameter(torch.empty(side * side, heads))
        coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                            indexing="ij")).flatten(1)
        rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
        self.register_buffer("relative_position_index", rel[0] * side + rel[1])

    def forward(self, x):  # (windows, tokens, dim)
        bw, n, c = x.shape
        q, k, v = self.qkv(x).view(bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        attn = q @ k.transpose(-2, -1) * self.scale + bias.view(n, n, -1).permute(2, 0, 1)
        return (attn.softmax(-1) @ v).transpose(1, 2).reshape(bw, n, c)


class Toy(nn.Module):
    """image (B, 3, H, W), focal (B,) -> depth (B, 1, H, W)."""

    def __init__(self, config: dict):
        super().__init__()
        c, self.patch, self.window = config["embed_dim"], config["patch"], config["window"]
        self.max_depth = config["max_depth"]
        self.stem = Conv(3, c, self.patch, stride=self.patch)
        angles = torch.arange(self.window ** 2)[:, None] / 100.0 ** (torch.arange(c) // 2 * 2 / c)
        self.register_buffer("position", torch.where(torch.arange(c) % 2 == 0, angles.sin(),
                                                     angles.cos()))
        self.norm = nn.LayerNorm(c)
        self.attn = WindowAttention(c, config["heads"], self.window)
        self.head = Conv(c, 1, 3, padding=1)

    def forward(self, image, focal):
        x = self.stem(image)
        b, c, h, w = x.shape
        s = self.window
        t = x.view(b, c, h // s, s, w // s, s).permute(0, 2, 4, 3, 5, 1).reshape(-1, s * s, c)
        t = t + self.position
        t = t + self.attn(self.norm(t))
        x = t.view(b, h // s, w // s, s, s, c).permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)
        depth = self.max_depth * torch.sigmoid(self.head(x))
        return depth.repeat_interleave(self.patch, 2).repeat_interleave(self.patch, 3)


class Port(Toy):
    def forward(self, image, focal):
        return [super().forward(image, focal)]


def reference(config: dict) -> Toy:
    return Toy(config)


def port_config(config: dict, seed: int):
    return SimpleNamespace(compute_dtype=config["compute_dtype"])


def port_model(config: dict, state_dict: Dict[str, torch.Tensor], device: torch.device):
    """Built on ``device``, so that it computes its own buffers, which the
    seeded state dict does not hold."""
    with torch.device(device):
        model = Port(config)
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    assert not unexpected and set(missing) == {"position", "attn.relative_position_index"}
    return model


def counters() -> Dict[str, int]:
    return {}


def tiny(config: dict) -> dict:
    return copy.deepcopy(config)
