"""The train state and the train step: ``bts_tpu/training/state.py``.

One step (reference hot loop, pytorch/bts_main.py:439-466): the host batch
goes to the device, is augmented there under ``--device_augment``, runs
through the model in train mode (bf16 autocast under ``--compute_dtype
bfloat16``), and the silog loss of the final depth (``outs[4]``, mask
``depth_gt > cfg.depth_mask_min``) is taken in f32; then backward and the
optimizer's update. The step returns the loss as a device tensor and does not
synchronise: the loop reads it back a few steps later.

BN runs in train mode (torch's update rule: momentum, Bessel-corrected
running variance) unless ``bn_no_track_stats`` or the TF graph, which run
every BN module in eval mode inside the train-mode model (the reference's
bn_init_as_tf, pytorch/bts.py:26-31; the TF reference always trains so,
tensorflow/bts.py:188-192, tensorflow/bts_main.py:167-168). The dense blocks take the unfused cuDNN modules under
grad (``DenseBlock``'s ``auto``): the fused kernels are inference-only, as
their Pallas originals were.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from bts_tpu_torch.config import Config
from bts_tpu_torch.data.device_augment import augment_batch
from bts_tpu_torch.training.loss import silog_loss
from bts_tpu_torch.training.optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    step: int = 0


def autocast_dtype(cfg: Config):
    """bf16 under ``--compute_dtype bfloat16``, else None (f32)."""
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    if cfg.compute_dtype == "float32":
        return None
    raise ValueError(f"compute_dtype must be float32 or bfloat16 (got {cfg.compute_dtype!r})")


def augment_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s augmentation: one seed per
    (seed, step), so a step's draw does not depend on the steps before it
    (``jax.random.fold_in(key(seed), step)`` in ``bts_tpu``)."""
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def set_bn_mode(model: nn.Module, cfg: Config) -> nn.Module:
    """model.train(), with every BN module in eval mode under
    ``bn_no_track_stats`` and in the TF graph (fine-tuning a TF checkpoint
    normalizes by its moving statistics and leaves them as they are)."""
    model.train()
    if cfg.bn_no_track_stats or cfg.resolved_flavor == "tf":
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
    return model


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy NHWC) as tensors on ``device``."""
    pin = device.type == "cuda"
    out = {}
    for k in ("image", "depth", "focal"):
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        out[k] = (t.pin_memory() if pin else t).to(device, non_blocking=pin)
    return out


def device_view(batch: Dict[str, torch.Tensor], cfg: Config, step: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image NCHW, depth NHW1) as the model sees them at ``step``: the
    batch itself, or its device augmentation under ``--device_augment``
    (rotation stays on the host: do_random_rotate=False here)."""
    image, depth = batch["image"], batch["depth"]
    if cfg.device_augment:
        image, depth = augment_batch(
            augment_generator(cfg.seed, step), image, depth,
            out_h=cfg.input_height, out_w=cfg.input_width, degree=cfg.degree,
            dataset=cfg.dataset, do_random_rotate=False,
            normalization=cfg.resolved_normalization,
        )
    return image.permute(0, 3, 1, 2), depth


def forward_loss(model: nn.Module, image: torch.Tensor, depth: torch.Tensor,
                 focal: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The model's forward and the silog loss of its final depth, in f32."""
    dtype = autocast_dtype(cfg)
    with torch.autocast(image.device.type, dtype=dtype or torch.float32,
                        enabled=dtype is not None):
        outs = model(image, focal)
    depth_est = outs[4][:, 0]
    depth_gt = depth[..., 0]
    return silog_loss(depth_est, depth_gt, depth_gt > cfg.depth_mask_min, cfg.variance_focus)


def make_train_step(cfg: Config) -> Callable[[TrainState, Dict[str, torch.Tensor]], torch.Tensor]:
    """(state, device batch) -> loss (a device tensor, not read back). The
    state advances in place; after the step each parameter's ``.grad``
    holds the step's gradient. Its four parts are ``torch.profiler`` ranges
    (``train_step/augment``, ``/forward``, ``/backward``, ``/optimizer``),
    which cost nothing measurable when no profiler runs."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with record_function("train_step/augment"):
            set_bn_mode(state.model, cfg)
            image, depth = device_view(batch, cfg, state.step)
        state.optimizer.zero_grad()
        with record_function("train_step/forward"):
            loss = forward_loss(state.model, image, depth, batch["focal"], cfg)
        with record_function("train_step/backward"):
            loss.backward()
        with record_function("train_step/optimizer"):
            state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step


def make_panel_forward(model: nn.Module, cfg: Config):
    """An eval-mode forward for TensorBoard image panels: the same device
    view the train step saw at ``step`` (same augmentation draw), so the
    panels show what the network trained on (pytorch/bts_main.py:482-496).
    Returns fn(device batch, step) -> (outs, image NHWC, depth NHW1)."""
    dtype = autocast_dtype(cfg)

    @torch.no_grad()
    def fwd(batch: Dict[str, torch.Tensor], step: int):
        image, depth = device_view(batch, cfg, step)
        was_training = model.training
        model.eval()
        try:
            with torch.autocast(image.device.type, dtype=dtype or torch.float32,
                                enabled=dtype is not None):
                outs = model(image, batch["focal"])
        finally:
            model.train(was_training)
        return [o.float() for o in outs], image.permute(0, 2, 3, 1), depth

    return fwd
