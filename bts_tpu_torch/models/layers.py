"""Shared building blocks.

Port of ``bts_tpu/models/layers.py`` (NCHW). Convolutions and batch norms
are ``torch.nn``'s own (``bts_tpu`` wrapped flax's to get torch semantics);
what remains are the BatchNorm constants, the nearest resamplers (with the
TF graph's align-corners downsample) and slim's SAME padding.

The transformers' blocks, shared by Swin and the CRF levels (NeWCRFs) and
the ViT (Depth Anything): ``LayerNorm`` through ``ops/layer_norm`` (the
kernel on a card), the GELU ``Mlp``, and their seeded init
(``seeded_init``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from bts_tpu_torch.ops.layer_norm import layer_norm

# Decoder BNs: torch momentum 0.01, eps 1.1e-5; the inner atrous BN keeps
# torch's default eps 1e-5. Encoder BNs: torchvision's momentum 0.1, eps 1e-5.
# The TF graph builds every BN, encoder and decoder, with eps 1.1e-5
# (tensorflow/bts.py:189-193).
TORCH_BN_MOMENTUM_DECODER = 0.01
DECODER_BN_EPS = 1.1e-5
TORCH_BN_MOMENTUM_ENCODER = 0.1
ENCODER_BN_EPS = 1e-5
TF_BN_EPS = 1.1e-5


def decoder_bn(channels: int, eps: float = DECODER_BN_EPS) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=TORCH_BN_MOMENTUM_DECODER)


def encoder_bn(channels: int, eps: float = ENCODER_BN_EPS) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=TORCH_BN_MOMENTUM_ENCODER)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """slim/TF 'SAME' padding of one spatial dim, (before, after): out =
    ceil(size/s), total = max((out-1)*s + k - size, 0), the extra pixel
    after. k7/s2 and k3/s2 on even sizes pad (2, 3) and (0, 1), where
    torch's symmetric padding takes (3, 3) and (1, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest upsample by an integer factor, NCHW: out[i] = in[i // k]."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
    return x.reshape(b, c, h * scale, w * scale)


def downsample_nearest(x: torch.Tensor, inv_scale: int) -> torch.Tensor:
    """Nearest downsample by an integer factor, NCHW: out[i] = in[i * k]."""
    return x[..., ::inv_scale, ::inv_scale]


def align_corners_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source rows of TF1's resize_nearest_neighbor(align_corners=True):
    floor(i * (n_in - 1) / (n_out - 1) + 0.5), in f64 as the legacy kernel
    (and bts_tpu) computes them; 16 -> 4 picks [0, 5, 10, 15]."""
    if n_out == 1:
        return np.zeros(1, np.int64)
    scale = (n_in - 1) / (n_out - 1)
    return np.floor(np.arange(n_out) * scale + 0.5).astype(np.int64)


_AC_INDICES: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _ac_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """align_corners_indices on ``device``, made once per size and device
    (a fresh host-to-device copy every forward would wait for the stream)."""
    key = (n_in, n_out, device)
    if key not in _AC_INDICES:
        _AC_INDICES[key] = torch.from_numpy(align_corners_indices(n_in, n_out)).to(device)
    return _AC_INDICES[key]


def downsample_nearest_ac(x: torch.Tensor, inv_scale: int) -> torch.Tensor:
    """The TF graph's nearest downsample by an integer factor, NCHW:
    resize_nearest_neighbor(align_corners=True) (tensorflow/bts.py:66-73),
    a gather of the align-corners rows and columns."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _ac_index(h, h // inv_scale, x.device))
    return x.index_select(-1, _ac_index(w, w // inv_scale, x.device))


def gemm_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a Linear or a convolution reads x in: autocast's where it
    is on for x's device, else float32."""
    kind = x.device.type
    return torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else torch.float32


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dimension through ``ops/layer_norm``,
    in float32 whatever the input's dtype. ``to_gemm``: the output's one
    reader is a Linear or a convolution, which autocast feeds in its own
    dtype; under autocast such a norm writes that dtype, rounded where the
    reader would round it. Every other norm writes float32."""

    def __init__(self, dim: int, to_gemm: bool, eps: float = 1e-5):
        super().__init__(dim, eps=eps)
        self.to_gemm = to_gemm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = gemm_dtype(x) if self.to_gemm else torch.float32
        return layer_norm(x, self.weight, self.bias, self.eps, out)


class Mlp(nn.Module):
    """``fc2(GELU(fc1(x)))``, GELU the exact (erf) form."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


@torch.no_grad()
def seeded_init(model: nn.Module, generator: torch.Generator, normal: Sequence[str],
                ones: Sequence[str] = ("weight",)) -> nn.Module:
    """Seeded init from the CPU ``generator``, parameter by parameter in
    ``named_parameters`` order: a name ending in one of ``normal`` a normal
    of std 0.02 truncated at +-2; any other of 2 or more dimensions
    Xavier-uniform (convolutions, transposed convolutions, linear layers);
    the rest 1 where the name ends in one of ``ones`` (norms at identity),
    else 0 (biases)."""
    for name, p in model.named_parameters():
        if name.endswith(tuple(normal)):
            p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), std=0.02, generator=generator))
        elif p.dim() >= 2:
            fan = math.prod(p.shape[2:])
            bound = math.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * fan))
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
        else:
            p.fill_(1.0 if name.endswith(tuple(ones)) else 0.0)
    return model
