"""DenseNet-121/161 encoders (NCHW), with the five BTS skips.

Port of ``bts_tpu/models/encoders/densenet.py``, written by hand in
torchvision's layout and module names so that reference and torchvision
state dicts load as they are: ``base_model`` is torchvision's ``features``
(conv0 -> norm0 -> relu0 [skip] -> pool0 [skip] -> denseblock1 ->
transition1 [skip] -> denseblock2 -> transition2 [skip] -> denseblock3 ->
transition3 -> denseblock4 -> norm5 [skip, pre-ReLU]).

feat_out_channels: densenet121 [64, 64, 128, 256, 1024];
densenet161 [96, 96, 192, 384, 2208].

The TF graph (``bn_eps=1.1e-5, tf_stem=True``, ``models/bts.py``'s
``flavor="tf"``) builds every BN with eps 1.1e-5 and pads the stem's 7x7/s2
conv and 3x3/s2 max-pool with slim's SAME padding, (2, 3) and (0, 1) on even
sizes; everything after the stem pads alike in both graphs.

``DenseNetEncoder.dense_impl`` picks how the dense layers run (the same
function either way):
  - ``auto``: the fused taps kernel on a CUDA tensor in eval mode with grad
    off (as ``apps/predict.py`` runs under ``inference_mode``); the unfused
    modules anywhere else;
  - ``plain``: always the unfused modules;
  - ``taps`` / ``eo``: the fused layer (``ops/fused_dense.py``): the CUDA
    kernel on a CUDA tensor, its plain version on the CPU. Inference only:
    they raise in train mode or with grad enabled.
A fused block carries one channels-last buffer of its final width from its
first layer to its last; each layer reads a channel prefix of it and writes
its G new channels in place, so there is no per-layer concat or layout
conversion.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import ENCODER_BN_EPS, encoder_bn, same_pads
from bts_tpu_torch.ops.fused_dense import (
    fold_bn,
    fused_dense_layer,
    pack_eo_kmajor,
    pack_taps_kmajor,
    pack_w2_eo,
)

DENSE_IMPLS = ("auto", "taps", "eo", "plain")

SKIP_NAMES = ("relu0", "pool0", "transition1", "transition2", "norm5")


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 conv(4g) -> BN -> ReLU -> 3x3 conv(g)."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 4,
                 bn_eps: float = ENCODER_BN_EPS):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = encoder_bn(in_features, bn_eps)
        self.relu1 = nn.ReLU()
        self.conv1 = nn.Conv2d(in_features, mid, 1, bias=False)
        self.norm2 = encoder_bn(mid, bn_eps)
        self.relu2 = nn.ReLU()
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

        self._folded = None  # (key, weights) of the last fold, see folded()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.relu1(self.norm1(x)))
        return self.conv2(self.relu2(self.norm2(y)))

    def _sources(self):
        n1, n2 = self.norm1, self.norm2
        return (n1.weight, n1.bias, n1.running_mean, n1.running_var, self.conv1.weight,
                n2.weight, n2.bias, n2.running_mean, n2.running_var, self.conv2.weight)

    def folded(self, dtype: torch.dtype, eo: bool):
        """(s1, b1, w1, s2, b2, w2, w2q, kmajor) in ``dtype`` on the weights'
        device, for the fused layer: BN folded in f32, w1 (C, Cmid), w2
        (3,3,Cmid,G), w2q = pack_w2_eo(w2) (None unless ``eo``), kmajor =
        the kernel's K-major copies, in f32 split into their TF32 halves:
        pack_eo_kmajor(w1, w2q) for eo, pack_taps_kmajor(w1, w2) for taps.

        Cached, keyed on every source tensor's storage and version, so
        load_state_dict, .to(), in-place changes to the weights (an
        optimizer step) and a new dtype each compute it afresh. A train-mode
        forward updates the BN statistics in place without bumping their
        versions, so the key also holds the versions of both BN modules'
        ``num_batches_tracked``, which that forward increments. BN folds with
        each module's own eps (1.1e-5 in the TF graph). Weights made
        under ``inference_mode`` have no version counter: they are folded
        anew on every call.
        """
        src = self._sources()
        tracked = [n.num_batches_tracked for n in (self.norm1, self.norm2)
                   if n.num_batches_tracked is not None]
        key = None
        if not any(t.is_inference() for t in (*src, *tracked)):
            key = (dtype, eo) + tuple((t.device, t.data_ptr(), t._version)
                                      for t in (*src, *tracked))
            if self._folded is not None and self._folded[0] == key:
                return self._folded[1]
        with torch.no_grad():
            g1, be1, m1, v1, c1, g2, be2, m2, v2, c2 = (t.detach().float() for t in src)
            s1, b1 = fold_bn(g1, be1, m1, v1, self.norm1.eps)
            s2, b2 = fold_bn(g2, be2, m2, v2, self.norm2.eps)
            w1 = c1[:, :, 0, 0].t()
            w2 = c2.permute(2, 3, 1, 0)
            weights = [t.to(dtype).contiguous() for t in (s1, b1, w1, s2, b2, w2)]
            w2q = pack_w2_eo(weights[5]) if eo else None
            weights.append(w2q)
            weights.append(pack_eo_kmajor(weights[2], w2q) if eo
                           else pack_taps_kmajor(weights[2], weights[5]))
        self._folded = (key, tuple(weights))
        return self._folded[1]

    def fused_into(self, buf: torch.Tensor, c: int, impl: str) -> None:
        """Read channels [0, c) of the NHWC buffer, write the layer's G new
        channels to [c, c + G)."""
        s1, b1, w1, s2, b2, w2, w2q, kmajor = self.folded(buf.dtype, impl == "eo")
        g = w2.shape[3]
        fused_dense_layer(buf[..., :c], s1, b1, w1, s2, b2, w2, impl=impl, w2q=w2q,
                          out=buf[..., c:c + g], kmajor=kmajor)


class DenseBlock(nn.ModuleDict):
    """Each layer sees the concatenation of the block input and all new
    features so far; returns that concatenation."""

    def __init__(self, num_layers: int, in_features: int, growth_rate: int,
                 bn_eps: float = ENCODER_BN_EPS):
        super().__init__()
        for i in range(num_layers):
            self[f"denselayer{i + 1}"] = DenseLayer(in_features + i * growth_rate, growth_rate,
                                                    bn_eps=bn_eps)

    def forward(self, x: torch.Tensor, impl: str = "plain") -> torch.Tensor:
        if impl == "auto":
            fused = x.is_cuda and not self.training and not torch.is_grad_enabled()
            impl = "taps" if fused else "plain"
        if impl == "plain":
            for layer in self.values():
                x = torch.cat([x, layer(x)], dim=1)
            return x
        if self.training or torch.is_grad_enabled():
            raise RuntimeError(
                f"dense_impl {impl!r} is inference-only (the fused layer has no backward): "
                "use eval mode with grad disabled, or dense_impl 'plain'"
            )
        b, c, h, w = x.shape
        layers = list(self.values())
        growth = layers[0].conv2.out_channels
        buf = torch.empty((b, c + len(layers) * growth, h, w), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        buf[:, :c] = x
        nhwc = buf.permute(0, 2, 3, 1)
        for layer in layers:
            layer.fused_into(nhwc, c, impl)
            c += growth
        return buf


class Transition(nn.Sequential):
    """BN -> ReLU -> 1x1 conv -> avgpool 2x2/2."""

    def __init__(self, in_features: int, out_features: int, bn_eps: float = ENCODER_BN_EPS):
        super().__init__(
            OrderedDict(
                norm=encoder_bn(in_features, bn_eps),
                relu=nn.ReLU(),
                conv=nn.Conv2d(in_features, out_features, 1, bias=False),
                pool=nn.AvgPool2d(2, stride=2),
            )
        )


class DenseNetEncoder(nn.Module):
    """Image (B,3,H,W) -> the 5 skips [H/2, H/4, H/8, H/16, H/32]."""

    def __init__(
        self,
        block_config: Sequence[int],
        growth_rate: int,
        num_init_features: int,
        dense_impl: str = "auto",
        bn_eps: float = ENCODER_BN_EPS,
        tf_stem: bool = False,
    ):
        super().__init__()
        # The TF stem pads in forward(), by the input's size.
        mods = OrderedDict(
            conv0=nn.Conv2d(3, num_init_features, 7, stride=2, padding=0 if tf_stem else 3,
                            bias=False),
            norm0=encoder_bn(num_init_features, bn_eps),
            relu0=nn.ReLU(),
            pool0=nn.MaxPool2d(3, stride=2, padding=0 if tf_stem else 1),
        )
        c = num_init_features
        for i, num_layers in enumerate(block_config):
            mods[f"denseblock{i + 1}"] = DenseBlock(num_layers, c, growth_rate, bn_eps)
            c += num_layers * growth_rate
            if i != len(block_config) - 1:
                mods[f"transition{i + 1}"] = Transition(c, c // 2, bn_eps)
                c //= 2
        mods["norm5"] = encoder_bn(c, bn_eps)
        self.base_model = nn.Sequential(mods)
        self.dense_impl = dense_impl
        self.tf_stem = tf_stem

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.dense_impl not in DENSE_IMPLS:
            raise ValueError(
                f"dense_impl must be one of {'/'.join(DENSE_IMPLS)} (got {self.dense_impl!r})"
            )
        skips = []
        for name, module in self.base_model.named_children():
            if self.tf_stem and name in ("conv0", "pool0"):
                # slim SAME; the pool follows a ReLU, so zeros pad as TF's
                # ignored border does.
                k = 7 if name == "conv0" else 3
                x = F.pad(x, (*same_pads(x.shape[-1], k, 2), *same_pads(x.shape[-2], k, 2)))
            if isinstance(module, DenseBlock):
                x = module(x, self.dense_impl)
            else:
                x = module(x)
            if name in SKIP_NAMES:
                skips.append(x)
        return skips


def densenet121(bn_eps: float = ENCODER_BN_EPS, tf_stem: bool = False) -> DenseNetEncoder:
    return DenseNetEncoder((6, 12, 24, 16), 32, 64, bn_eps=bn_eps, tf_stem=tf_stem)


def densenet161(bn_eps: float = ENCODER_BN_EPS, tf_stem: bool = False) -> DenseNetEncoder:
    return DenseNetEncoder((6, 12, 36, 24), 48, 96, bn_eps=bn_eps, tf_stem=tf_stem)
