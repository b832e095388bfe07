"""Weights into the port: bts_tpu (flax) trees and reference ``.pth`` files.

The port's module names are the reference PyTorch names, so a reference
checkpoint is already a state dict of this model (``load_checkpoint``).
``state_dict_from_flax`` maps ``bts_tpu``'s param/batch_stats trees onto
those names. The key mapping is a copy of the DenseNet and decoder part of
``bts_tpu/models/convert.py`` (``_torch_key``), because importing that
module loads flax through ``bts_tpu/models/__init__.py``.

Layout: flax kernel (kh, kw, I, O) -> torch weight (O, I, kh, kw); BN
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF_RENAME = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}

# Decoder convs wrapped in torch Sequential(conv, activation) -> index 0.
_SEQ_CONVS = {"conv5", "conv4", "conv3", "conv2", "conv1", "daspp_conv", "get_depth"}

_ATROUS = {
    "first_bn": "atrous_conv.first_bn",
    "conv1": "atrous_conv.aconv_sequence.1",
    "bn2": "atrous_conv.aconv_sequence.2",
    "conv2": "atrous_conv.aconv_sequence.4",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _decoder_key(parts, leaf: str, leaf_shape) -> str:
    head = parts[0]
    if head.startswith("upconv"):
        return f"{head}.conv.{leaf}"
    if head.startswith("bn"):
        return f"{head}.{leaf}"
    if head.startswith("daspp_") and head != "daspp_conv":
        return f"{head}.{_ATROUS[parts[1]]}.{leaf}"
    if head.startswith("reduc"):
        sub = parts[1]
        if sub == "plane_params":
            return f"{head}.reduc.plane_params.{leaf}"
        if sub == "final":
            return f"{head}.reduc.final.0.{leaf}"
        # inter_k: the torch name is inter_{in}_{out}, from the kernel shape.
        return f"{head}.reduc.inter_{int(leaf_shape[2])}_{int(leaf_shape[3])}.0.{leaf}"
    if head in _SEQ_CONVS:
        return f"{head}.0.{leaf}"
    raise KeyError(f"unknown decoder module: {parts}")


def torch_key(path: Tuple[str, ...], leaf_shape) -> str:
    """bts_tpu flax param path -> reference torch state-dict key.

    Every leaf lives under a Conv/BatchNorm shim whose inner module is
    'conv'/'bn' (path[-2]); the torch module path is everything above it.
    """
    leaf = _LEAF_RENAME[path[-1]]
    scope, rest = path[0], list(path[1:-2])
    if scope == "encoder":
        return "encoder.base_model." + ".".join(rest) + "." + leaf
    if scope == "decoder":
        return "decoder." + _decoder_key(rest, leaf, leaf_shape)
    raise KeyError(f"unknown scope for {path}")


def state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """bts_tpu BTSModel (params, batch_stats) trees of numpy arrays -> the
    port's state dict, ``num_batches_tracked`` = 0 for every BN."""
    state: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in _flatten(tree).items():
            arr = np.asarray(leaf, dtype=np.float32)
            key = torch_key(path, arr.shape)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            state[key] = torch.tensor(arr)
            if path[-1] == "mean":
                tracked = key[: -len("running_mean")] + "num_batches_tracked"
                state[tracked] = torch.zeros((), dtype=torch.long)
    return state


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference or port ``.pth`` (a torch.save dict with a 'model'
    key, or a bare state dict) -> state dict, DDP 'module.' prefix stripped.
    Loads tensors only (``weights_only``), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return {k.removeprefix("module."): v for k, v in state.items()}
