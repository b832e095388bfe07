"""TF checkpoints into the port: ``bts_tpu/models/convert_tf.py``.

The reference's TF stack trains from a slim ImageNet DenseNet
(tensorflow/bts_main.py:95-123,228-232) and ships trained TF checkpoints
(``bts_nyu_v2``, ``bts_eigen_v2``, tensorflow/README.md:89,198). Their
variable names follow the reference graph's scopes (tensorflow/bts.py):

    model/encoder/densenet161/conv1/weights
    model/encoder/densenet161/BatchNorm/{gamma,beta,moving_mean,moving_variance}
    model/encoder/densenet161/dense_blockK/conv_blockJ/x1/{BatchNorm,Conv}/...
    model/encoder/densenet161/transition_blockK/blk/{BatchNorm,Conv}/...
    model/encoder/densenet161/final_block/BatchNorm/...
    model/decoder/Conv, Conv_1, ..., BatchNorm, BatchNorm_1, ...

The decoder's scopes are slim's auto-numbering in graph-build order, which
``tf_decoder_name_map`` reproduces by walking the build (tensorflow/bts.py:
237-345). Each variable is named here by ``bts_tpu``'s flax path and lands
on the port's state dict through ``convert.state_dict_from_flax``: slim
kernels are HWIO, as flax's, and the bridge transposes them to OIHW.

``convert_full_tf`` is strict both ways (every model tensor loads, every
``model/`` variable is consumed), so a numbering error fails loudly; run its
result in the TF graph (``BTSModel(flavor="tf")``). ``warm_start_from_tf``
is the reference's encoder warm start by name intersection.

tensorflow is imported only inside the functions that read a checkpoint, and
without it they raise ``ImportError``: a TF checkpoint is never taken for a
PyTorch one.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from bts_tpu_torch.models.convert import _unflatten, state_dict_from_flax

# Encoders the TF reference builds (tensorflow/bts.py:398-430).
_TF_ARCHS = ("densenet121", "densenet161")

_BN_LEAVES = {
    "scale": "gamma",
    "bias": "beta",
    "mean": "moving_mean",
    "var": "moving_variance",
}

_TRACKED = "num_batches_tracked"


def _tensorflow(path: str):
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"{path} is a TF checkpoint: reading it needs tensorflow, which does not import "
            f"here ({e})"
        ) from e
    return tf


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a TF checkpoint (the enumeration of the reference's
    get_tensors_in_checkpoint_file, tensorflow/bts_main.py:95-107)."""
    reader = _tensorflow(path).train.load_checkpoint(path)
    return {name: np.asarray(reader.get_tensor(name))
            for name in sorted(reader.get_variable_to_shape_map())}


def is_tf_checkpoint(path: str) -> bool:
    """TF checkpoints are '<prefix>.index' + '<prefix>.data-*', or a
    directory with a 'checkpoint' file. Reads no tensor."""
    return os.path.isfile(path + ".index") or os.path.isfile(os.path.join(path, "checkpoint"))


def tf_latest_checkpoint(path: str):
    """The newest checkpoint prefix of a TF checkpoint directory, else None."""
    return _tensorflow(path).train.latest_checkpoint(path)


def _tf_encoder_name(parts: Tuple[str, ...], leaf: str) -> str:
    """Flax encoder path (below 'encoder/', above the conv/bn shim) and leaf
    -> the TF variable name below '<arch>/'. KeyError where the TF graph has
    no such variable."""
    head = parts[0]
    if head == "conv0":
        return "conv1/weights"
    if head == "norm0":  # the stem's bare slim.batch_norm scope
        return f"BatchNorm/{_BN_LEAVES[leaf]}"
    if head == "norm5":
        return f"final_block/BatchNorm/{_BN_LEAVES[leaf]}"
    m = re.fullmatch(r"denseblock(\d+)", head)
    if m:
        j = re.fullmatch(r"denselayer(\d+)", parts[1]).group(1)
        sub = parts[2]  # norm1 | conv1 | norm2 | conv2
        x = "x1" if sub.endswith("1") else "x2"
        if sub.startswith("norm"):
            return f"dense_block{m.group(1)}/conv_block{j}/{x}/BatchNorm/{_BN_LEAVES[leaf]}"
        return f"dense_block{m.group(1)}/conv_block{j}/{x}/Conv/weights"
    m = re.fullmatch(r"transition(\d+)", head)
    if m:
        if parts[1] == "norm":
            return f"transition_block{m.group(1)}/blk/BatchNorm/{_BN_LEAVES[leaf]}"
        return f"transition_block{m.group(1)}/blk/Conv/weights"
    raise KeyError(f"no TF name for encoder path {parts}")


def _encoder_path(key: str, shape) -> Tuple[str, ...]:
    """A DenseNet encoder key of the port's state dict -> bts_tpu's flax path:
    'encoder.base_model.denseblock1.denselayer1.norm1.weight' ->
    ('encoder', 'denseblock1', 'denselayer1', 'norm1', 'bn', 'scale')."""
    *parts, leaf = key.split(".")[2:]
    if leaf == "weight" and len(shape) == 4:
        return ("encoder", *parts, "conv", "kernel")
    flax_leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                 "running_var": "var"}[leaf]
    return ("encoder", *parts, "bn", flax_leaf)


def _find_root(tf_names, encoder_name: str) -> str:
    """The scope above '<arch>/conv1/weights' (the reference roots it at
    'model/encoder/<arch>/'; shallower re-exports are accepted)."""
    arch = encoder_name.replace("_bts", "")
    if arch not in _TF_ARCHS:
        raise ValueError(
            f"TF checkpoints hold {_TF_ARCHS} (tensorflow/bts.py:398-430); got encoder "
            f"'{encoder_name}'"
        )
    suffix = f"{arch}/conv1/weights"
    roots = [n[: -len(suffix)] for n in tf_names if n.endswith(suffix)]
    if not roots:
        raise KeyError(f"checkpoint has no '{suffix}' variable: not a reference-style {arch} "
                       "checkpoint")
    return sorted(roots, key=len)[0] + arch + "/"


def tf_decoder_name_map(num_features: int) -> Dict[str, str]:
    """Flax decoder path (below 'decoder/') -> TF variable name below
    'decoder/', reproducing slim's numbering (Conv, Conv_1, ...; BatchNorm,
    BatchNorm_1, ...) by walking the TF graph's build order
    (tensorflow/bts.py:237-345). Every decoder conv has weights and biases
    (the arg scope at :346-349,404-405 sets only the activation)."""
    counters = {"Conv": -1, "BatchNorm": -1}
    out = {}

    def _next(kind):
        counters[kind] += 1
        return kind if counters[kind] == 0 else f"{kind}_{counters[kind]}"

    def conv(head):
        s = _next("Conv")
        out[f"{head}/conv/kernel"] = f"{s}/weights"
        out[f"{head}/conv/bias"] = f"{s}/biases"

    def bn(head):
        s = _next("BatchNorm")
        for leaf, tf_leaf in _BN_LEAVES.items():
            out[f"{head}/bn/{leaf}"] = f"{s}/{tf_leaf}"

    def atrous(name, bn_first=True):
        # tensorflow/bts.py:84-100: [BN] -> relu -> 1x1 conv -> BN -> relu
        # -> 3x3 rate conv.
        if bn_first:
            bn(f"{name}/first_bn")
        conv(f"{name}/conv1")
        bn(f"{name}/bn2")
        conv(f"{name}/conv2")

    def reduc(name, start, is_final=False):
        # tensorflow/bts.py:145-166, the channel-halving loop of Reduction1x1.
        n, i = start, 0
        while n >= 4:
            if n < 8:
                conv(f"{name}/final" if is_final else f"{name}/plane_params")
                break
            conv(f"{name}/inter_{i}")
            n //= 2
            i += 1

    nf = num_features
    conv("upconv5")
    bn("bn5")
    conv("conv5")
    conv("upconv4")
    bn("bn4")
    conv("conv4")
    bn("bn4_2")
    atrous("daspp_3", bn_first=False)
    for rate in (6, 12, 18, 24):
        atrous(f"daspp_{rate}")
    conv("daspp_conv")
    reduc("reduc8x8", nf // 4)
    conv("upconv3")
    bn("bn3")
    conv("conv3")
    reduc("reduc4x4", nf // 8)
    conv("upconv2")
    bn("bn2")
    conv("conv2")
    reduc("reduc2x2", nf // 16)
    conv("upconv1")
    # TF passes the current width (nf//16) into the final reduction
    # (tensorflow/bts.py:316), one halving more than PT's nf//32.
    reduc("reduc1x1", nf // 16, is_final=True)
    conv("conv1")
    conv("get_depth")
    return out


def is_full_tf_bts_checkpoint(path: str) -> bool:
    """True when the TF checkpoint at ``path`` holds decoder variables (a
    trained BTS model, not an ImageNet encoder). Reads the variable map only;
    raises ImportError without tensorflow."""
    reader = _tensorflow(path).train.load_checkpoint(path)
    return any("decoder/Conv/" in name for name in reader.get_variable_to_shape_map())


def _decoder_root(tf_names) -> str:
    suffix = "decoder/Conv/weights"
    roots = [n[: -len(suffix)] for n in tf_names if n.endswith(suffix)]
    if not roots:
        raise KeyError("checkpoint has no 'decoder/Conv/weights' variable: not a full "
                       "reference-style TF BTS checkpoint")
    return sorted(roots, key=len)[0] + "decoder/"


def _landed(flat: Mapping[Tuple[str, ...], np.ndarray], state: Mapping[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Flax-path arrays -> the port's names through the bridge, each checked
    against the shape of ``state``'s tensor; num_batches_tracked dropped."""
    out = {}
    for key, value in state_dict_from_flax(_unflatten(flat), {}).items():
        if key.endswith(_TRACKED):
            continue
        if key not in state:
            raise KeyError(f"{key} is not a tensor of the model (was it built with "
                           "flavor='tf'?)")
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(value.shape)} vs "
                             f"model {tuple(state[key].shape)}")
        out[key] = value.to(state[key].dtype)
    return out


def convert_full_tf(tf_vars: Mapping[str, np.ndarray], state: Mapping[str, torch.Tensor],
                    encoder_name: str, num_features: int
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """A complete reference TF BTS checkpoint (encoder and decoder) -> the
    state dict of the port's TF-graph model whose state dict is ``state``.

    Strict both ways: every tensor of ``state`` loads from the checkpoint and
    every 'model/' variable is consumed. Bookkeeping (global_step, Adam
    slots under a variable's name, EMA copies) is reported, not an error.
    num_batches_tracked keeps ``state``'s values. Returns (state dict, report
    with 'loaded' and 'skipped_non_model')."""
    enc_root = _find_root(tf_vars.keys(), encoder_name)
    dec_root = _decoder_root(tf_vars.keys())
    names = {}  # flax path -> TF name
    for key, value in state.items():
        if key.startswith("encoder.") and not key.endswith(_TRACKED):
            path = _encoder_path(key, value.shape)
            names[path] = enc_root + _tf_encoder_name(path[1:-2], path[-1])
    for joined, suffix in tf_decoder_name_map(num_features).items():
        names[("decoder", *joined.split("/"))] = dec_root + suffix

    flat, consumed, missing = {}, set(), []
    for path, name in names.items():
        if name not in tf_vars:
            missing.append(f"{'/'.join(path)} -> {name}")
            continue
        flat[path] = tf_vars[name]
        consumed.add(name)
    if missing:
        raise KeyError(f"{len(missing)} model tensors not found in the TF checkpoint (was the "
                       f"model built with flavor='tf'?): {missing[:5]}")
    # Every model variable is consumed: a slim numbering error shows here.
    # Optimizer slots live under a variable's name ('<var>/Adam').
    leftover = [n for n in sorted(tf_vars)
                if n not in consumed and (n.startswith(enc_root) or n.startswith(dec_root))
                and n.rsplit("/", 1)[0] not in consumed]
    if leftover:
        raise KeyError(f"{len(leftover)} model variables in the checkpoint have no model "
                       f"leaf: {leftover[:5]}")
    loaded = _landed(flat, state)
    absent = sorted(k for k in state if k not in loaded and not k.endswith(_TRACKED))
    if absent:
        raise KeyError(f"{len(absent)} model tensors have no TF variable (was the model "
                       f"built with flavor='tf'?): {absent[:5]}")
    out = {k: loaded.get(k, v) for k, v in state.items()}
    report = {"loaded": sorted(consumed),
              "skipped_non_model": [n for n in sorted(tf_vars) if n not in consumed]}
    return out, report


def load_full_tf(path: str, state: Mapping[str, torch.Tensor], encoder_name: str,
                 num_features: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``convert_full_tf`` of the checkpoint at ``path`` (a prefix, or a
    directory's newest). Returns (state dict, meta), meta holding
    'global_step' where the checkpoint stores it."""
    tf_vars = load_tf_checkpoint(tf_latest_checkpoint(path) or path)
    converted, _ = convert_full_tf(tf_vars, state, encoder_name, num_features)
    meta = {"global_step": int(tf_vars["global_step"])} if "global_step" in tf_vars else {}
    return converted, meta


def warm_start_from_tf(tf_vars: Mapping[str, np.ndarray], state: Mapping[str, torch.Tensor],
                       encoder_name: str
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """The reference's warm start by name intersection: every TF encoder
    variable that maps onto a tensor of ``state`` loads; the rest of
    ``state`` is kept. Returns (state dict, report): 'loaded' and
    'unmatched_checkpoint' are TF names, 'unmatched_model' the port's keys
    (the reference's console accounting, tensorflow/bts_main.py:110-123)."""
    root = _find_root(tf_vars.keys(), encoder_name)
    flat, loaded, unmatched_model = {}, [], []
    for key, value in state.items():
        if key.endswith(_TRACKED):
            continue
        name = None
        if key.startswith("encoder."):
            path = _encoder_path(key, value.shape)
            try:
                name = root + _tf_encoder_name(path[1:-2], path[-1])
            except (KeyError, AttributeError):
                name = None
        if name is None or name not in tf_vars:
            unmatched_model.append(key)
            continue
        flat[path] = tf_vars[name]
        loaded.append(name)
    out = dict(state)
    out.update(_landed(flat, state))
    taken = set(loaded)
    report = {"loaded": loaded,
              "unmatched_checkpoint": [n for n in sorted(tf_vars) if n not in taken],
              "unmatched_model": unmatched_model}
    return out, report
