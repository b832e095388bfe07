"""Weights into the port: bts_tpu (flax) trees and reference ``.pth`` files.

The port's module names are the reference PyTorch names, so a reference
checkpoint is already a state dict of this model (``load_checkpoint``).
``state_dict_from_flax`` maps ``bts_tpu``'s param/batch_stats trees onto
those names. The key mapping is a copy of ``bts_tpu/models/convert.py``'s
(``_torch_key`` with its ResNet renames, and the MobileNetV2 table of
``_full_mobilenet_key``), because importing that module loads flax through
``bts_tpu/models/__init__.py``.

Layout: flax kernel (kh, kw, I/groups, O) -> torch weight (O, I/groups, kh,
kw), grouped and depthwise kernels too; BN scale/bias/mean/var ->
weight/bias/running_mean/running_var. TF-flavor trees (``BTSModel(flavor=
"tf")``) carry conv biases; a bias is named by its conv's kernel.

``load_weights`` reads any checkpoint the port serves from: a reference or
port ``.pth``, or a TF checkpoint prefix (``convert_tf``).
"""

from __future__ import annotations

import re
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


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


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


def _encoder_key(parts) -> str:
    """ResNet block names to torchvision's; DenseNet names pass as they are."""
    out = []
    for p in parts:
        m = re.fullmatch(r"layer(\d+)_(\d+)", p)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
        else:
            out.append({"downsample_conv": "downsample.0",
                        "downsample_bn": "downsample.1"}.get(p, p))
    return ".".join(out)


# MobileNetV2 inverted residuals: (submodule, shim) -> the torchvision path
# under features.N, with and without the expand conv (only features_1 has
# expand ratio 1).
_MOBILENET_EXPAND = {
    ("expand", "conv"): "conv.0.0",
    ("expand", "bn"): "conv.0.1",
    ("depthwise", "conv"): "conv.1.0",
    ("depthwise", "bn"): "conv.1.1",
    ("project", "conv"): "conv.2",
    ("project_bn", "bn"): "conv.3",
}
_MOBILENET_NO_EXPAND = {
    ("depthwise", "conv"): "conv.0.0",
    ("depthwise", "bn"): "conv.0.1",
    ("project", "conv"): "conv.1",
    ("project_bn", "bn"): "conv.2",
}


def _mobilenet_key(path: Tuple[str, ...], leaf: str) -> str:
    """(encoder, features_N, ...) -> torchvision ``features`` naming:
    features_0/conv/conv -> 0.0, features_18/bn/bn -> 18.1,
    features_2/expand/conv/conv -> 2.conv.0.0, features_2/project/conv ->
    2.conv.2, ..."""
    idx = int(path[1].split("_")[1])
    sub = path[2]
    if sub in ("conv", "bn"):  # the stem and the head ConvBNReLU6
        return f"encoder.base_model.{idx}.{0 if sub == 'conv' else 1}.{leaf}"
    table = _MOBILENET_EXPAND if idx >= 2 else _MOBILENET_NO_EXPAND
    return f"encoder.base_model.{idx}.{table[sub, path[3]]}.{leaf}"


def torch_key(path: Tuple[str, ...], leaf_shape) -> str:
    """bts_tpu flax param path -> reference torch state-dict key.

    Every leaf lives under a Conv/BatchNorm shim whose inner module is
    'conv'/'bn' (path[-2]); the torch module path is everything above it.
    """
    leaf = _LEAF_RENAME[path[-1]]
    if len(path) > 1 and path[1].startswith("features_"):
        return _mobilenet_key(path, leaf)
    scope, rest = path[0], list(path[1:-2])
    if scope == "encoder":
        return "encoder.base_model." + _encoder_key(rest) + "." + leaf
    if scope == "decoder":
        return "decoder." + _decoder_key(rest, leaf, leaf_shape)
    raise KeyError(f"unknown scope for {path}")


def state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """bts_tpu BTSModel (params, batch_stats) trees of numpy arrays -> the
    port's state dict, ``num_batches_tracked`` = 0 for every BN."""
    state: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        flat = _flatten(tree)
        for path, leaf in flat.items():
            arr = np.asarray(leaf, dtype=np.float32)
            # A conv's bias is named by its kernel's shape (reduc inter_{in}_{out}).
            kernel = flat.get(path[:-1] + ("kernel",), leaf)
            key = torch_key(path, np.shape(kernel))
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            state[key] = torch.tensor(arr)
            if path[-1] == "mean":
                tracked = key[: -len("running_mean")] + "num_batches_tracked"
                state[tracked] = torch.zeros((), dtype=torch.long)
    return state


# Keys a reference checkpoint carries that the port's model has not: the
# ResNet family's classifier, which the reference wraps and never calls
# (pytorch/bts.py:281-296,303-318).
REFERENCE_ONLY = ("encoder.base_model.fc.",)


def model_state(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference or port state dict as the port's model names it: the DDP
    'module.' prefix stripped and the REFERENCE_ONLY keys dropped."""
    out = {}
    for k, v in state.items():
        k = k.removeprefix("module.")
        if not k.startswith(REFERENCE_ONLY):
            out[k] = v
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference or port ``.pth`` (a torch.save dict with a 'model'
    key, or a bare state dict) -> the model's state dict (``model_state``).
    Loads tensors only (``weights_only``), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return model_state(ckpt.get("model", ckpt))


def load_weights(path: str, model, cfg) -> Dict[str, torch.Tensor]:
    """The state dict for ``model`` from ``path``: a reference or port
    ``.pth`` (``load_checkpoint``), or a TF checkpoint prefix or directory,
    converted strictly onto the TF graph (``convert_tf.load_full_tf``; needs
    tensorflow)."""
    from bts_tpu_torch.models import convert_tf

    if convert_tf.is_tf_checkpoint(path):
        return convert_tf.load_full_tf(path, model.state_dict(), cfg.encoder, cfg.bts_size)[0]
    return load_checkpoint(path)
