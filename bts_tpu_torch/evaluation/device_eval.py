"""Batched eval metrics on the predictions' device: ``bts_tpu/evaluation/device_eval.py``.

The model's predictions stay on the card; the ground truth goes up once per
batch as raw uint16 (half the bytes of f32 meters), and masking, clamping
and the nine metrics run there. The only readback is 10 numbers: the nine
metric sums and the count of scored images.

Semantics pinned to ``evaluation/protocol.py`` (the numpy path, kept as the
cross-check in the tests):
  * clamp: inf -> max_depth_eval, nan -> min_depth_eval, clip to the range
    (pytorch/bts_main.py:275-278);
  * validity: gt in (min, max) intersected with the garg/eigen crop
    (pytorch/bts_main.py:280-295);
  * per-image metric means, summed over the images with any valid pixel.

Online eval sees pred.shape == gt.shape (the loader kb-crops the gt as it
crops the image, pytorch/bts_dataloader.py:174-175), so nothing is
re-embedded here; the kb re-embed is the offline PNG path's, in numpy.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from bts_tpu_torch.evaluation.metrics import compute_errors_masked
from bts_tpu_torch.evaluation.protocol import crop_mask


def gt_scale(dataset: str) -> float:
    """Raw png units per meter: 1000 (NYU) or 256 (KITTI)."""
    return 1000.0 if dataset == "nyu" else 256.0


def pack_gt_batch(depths, weights, dataset: str, pred_shape=None):
    """List of HW1 float-meter gt (or None) -> (B,H,W) uint16 raw batch.

    Depth values are k/1000 (NYU) or k/256 (KITTI) in f32, so the round trip
    back to uint16 is exact: the device sees the same meters after its own
    division. Samples with missing gt or weight 0 become all-zero (invalid
    everywhere).

    Returns (raw, effective_weights, mismatched): ``mismatched`` lists the
    indices of real samples whose gt shape differs from the batch shape
    (pred_shape when given, else the first valid gt). The batched metrics
    cannot score them, so the caller scores them per sample (every eval
    sample is counted exactly once, distributed_sampler_no_evenly_divisible.py:30-40),
    and a warning says so.
    """
    scale = gt_scale(dataset)
    arrs, eff, mismatched = [], [], []
    shape = tuple(pred_shape) if pred_shape is not None else None
    if shape is None:
        for d, w in zip(depths, weights):
            if d is not None and w > 0:
                shape = d.shape[:2]
                break
    if shape is None:
        return None, None, []
    for i, (d, w) in enumerate(zip(depths, weights)):
        if d is None or w == 0:
            arrs.append(np.zeros(shape, np.uint16))
            eff.append(0.0)
        elif d.shape[:2] != shape:
            arrs.append(np.zeros(shape, np.uint16))
            eff.append(0.0)
            mismatched.append(i)
        else:
            arrs.append(np.round(d[..., 0] * scale).astype(np.uint16))
            eff.append(1.0)
    if mismatched:
        warnings.warn(
            f"device eval: {len(mismatched)} gt sample(s) with shape != {shape} cannot ride "
            "the batched metric kernel; handing them to the per-sample host path (scored "
            "only if a shape-bridging protocol such as the kb-crop re-embed applies)",
            stacklevel=2,
        )
    return np.stack(arrs), np.asarray(eff, np.float32), mismatched


def upload_gt(gt_raw: np.ndarray, dataset: str, device) -> torch.Tensor:
    """(B,H,W) uint16 raw gt -> f32 meters on ``device``, bit for bit
    ``gt_raw.astype(np.float32) / scale``. The uint16 goes up as its bits in
    int16 (CUDA has few uint16 ops) and is widened there. The divisor is a
    tensor: PyTorch divides a CUDA tensor by a Python float as a multiply by
    its reciprocal, which is not the IEEE division."""
    bits = torch.from_numpy(np.ascontiguousarray(gt_raw).view(np.int16)).to(device)
    scale = torch.full((1,), gt_scale(dataset), dtype=torch.float32, device=device)
    return (bits.to(torch.int32) & 0xFFFF).to(torch.float32) / scale


def make_batch_metrics(cfg):
    """fn(preds (B,H,W) tensor, gt_raw (B,H,W) uint16 numpy, weights (B,)
    numpy) -> (metric sums (9,) f64 numpy, count float), computed on the
    predictions' device; the readback is those 10 numbers. The crop mask is
    built once per (h, w, device)."""
    min_d = float(cfg.min_depth_eval)
    max_d = float(cfg.max_depth_eval)
    masks = {}

    def batch_metrics(preds: torch.Tensor, gt_raw: np.ndarray, weights: np.ndarray):
        device = preds.device
        h, w = gt_raw.shape[1:]
        key = (h, w, device)
        if key not in masks:
            masks[key] = torch.from_numpy(
                crop_mask(h, w, cfg.dataset, cfg.garg_crop, cfg.eigen_crop)).to(device)
        gt = upload_gt(gt_raw, cfg.dataset, device)
        weight = torch.from_numpy(np.asarray(weights, np.float32)).to(device)
        valid = (gt > min_d) & (gt < max_d) & masks[key][None] & (weight > 0)[:, None, None]

        pred = torch.nan_to_num(preds.to(torch.float32), nan=min_d, posinf=max_d, neginf=max_d)
        pred = pred.clamp(min_d, max_d)

        metrics, has_valid = compute_errors_masked(gt, pred, valid)
        out = torch.cat([metrics.sum(0), has_valid.sum()[None]]).cpu().numpy().astype(np.float64)
        return out[:9], float(out[9])

    return batch_metrics


def run_batch(batch_metrics, preds: torch.Tensor, batch: dict, dataset: str) -> Optional[tuple]:
    """One eval batch through the device path. Returns (sums9, count,
    mismatched_indices) on the host, or None when the whole batch lacks
    usable gt. Mismatched-shape samples are not counted here: the caller
    scores them per sample (see pack_gt_batch)."""
    gt_raw, eff, mismatched = pack_gt_batch(
        batch["depths"], batch["weight"], dataset, pred_shape=tuple(preds.shape[1:3]))
    if gt_raw is None:
        return None
    if not eff.any():
        # Nothing the batched metrics can score: skip the device; mismatched
        # samples (if any) still go to the host path.
        if not mismatched:
            return None
        return np.zeros(9, np.float64), 0.0, mismatched
    sums, count = batch_metrics(preds, gt_raw, eff)
    return sums, count, mismatched
