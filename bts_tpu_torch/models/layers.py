"""Shared building blocks (NCHW).

Port of ``bts_tpu/models/layers.py``. Convolutions and batch norms are
``torch.nn``'s own (``bts_tpu`` wrapped flax's to get torch semantics); what
remains are the BatchNorm constants, the nearest resamplers (with the TF
graph's align-corners downsample) and slim's SAME padding.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

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
