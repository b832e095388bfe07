"""Shared building blocks (NCHW).

Port of ``bts_tpu/models/layers.py``. Convolutions and batch norms are
``torch.nn``'s own (``bts_tpu`` wrapped flax's to get torch semantics); what
remains are the BatchNorm constants and the nearest resamplers.
"""

from __future__ import annotations

import torch
from torch import nn

# Decoder BNs: torch momentum 0.01, eps 1.1e-5; the inner atrous BN keeps
# torch's default eps 1e-5. Encoder BNs: torchvision's momentum 0.1, eps 1e-5.
TORCH_BN_MOMENTUM_DECODER = 0.01
DECODER_BN_EPS = 1.1e-5
TORCH_BN_MOMENTUM_ENCODER = 0.1
ENCODER_BN_EPS = 1e-5


def decoder_bn(channels: int, eps: float = DECODER_BN_EPS) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=TORCH_BN_MOMENTUM_DECODER)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest upsample by an integer factor, NCHW: out[i] = in[i // k]."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
    return x.reshape(b, c, h * scale, w * scale)


def downsample_nearest(x: torch.Tensor, inv_scale: int) -> torch.Tensor:
    """Nearest downsample by an integer factor, NCHW: out[i] = in[i * k]."""
    return x[..., ::inv_scale, ::inv_scale]
