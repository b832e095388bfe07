"""The nine depth metrics: ``bts_tpu/evaluation/metrics.py`` in numpy and torch.

Reference: pytorch/bts_main.py:144-165 / utils/eval_with_pngs.py:50-71 --
metric order [silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3];
silog is scaled x100; d_k = mean(max(gt/pred, pred/gt) < 1.25^k).

Two implementations:
  * ``compute_errors``: numpy, on already-masked 1-D vectors, exactly the
    reference function (PNG eval and the per-sample host path);
  * ``compute_errors_masked``: torch on any device, in f32, on
    full-resolution tensors with a validity mask; per-image metrics, so
    batched device eval reads back one sum per metric.
"""

from __future__ import annotations

import numpy as np
import torch

EVAL_METRICS = ["silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1", "d2", "d3"]
# The first 6 are lower-better, the last 3 higher-better
# (pytorch/bts_main.py:514-521, the best-checkpoint logic).
NUM_LOWER_BETTER = 6
NUM_HIGHER_BETTER = 3


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Nine metrics from masked 1-D gt/pred vectors (numpy), as
    pytorch/bts_main.py:144-165 computes them."""
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = (thresh < 1.25).mean()
    d2 = (thresh < 1.25**2).mean()
    d3 = (thresh < 1.25**3).mean()

    rms = np.sqrt(((gt - pred) ** 2).mean())
    log_rms = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())

    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)

    err = np.log(pred) - np.log(gt)
    silog = np.sqrt(np.mean(err**2) - np.mean(err) ** 2) * 100

    log10 = np.mean(np.abs(np.log10(pred) - np.log10(gt)))

    return np.array([silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3], dtype=np.float64)


def compute_errors_masked(gt: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor):
    """Nine metrics over a masked tensor, in f32 on the tensors' device.

    gt, pred: identical shapes, (H, W) or (B, H, W); metrics are per image
    over the last two axes. mask: bool, the same shape.

    Returns (metrics, valid): metrics of shape batch_shape + (9,) in
    EVAL_METRICS order, and valid, per image 1.0 if any pixel is valid else
    0.0 (f32). Images with an empty mask give zero metrics and valid 0, as
    the reference skips a sample without gt (pytorch/bts_main.py:258-260).
    """
    dims = (-2, -1)
    m = mask.to(torch.float32)
    count = m.sum(dims)
    valid = (count > 0).to(torch.float32)
    cnt = count.clamp_min(1.0)

    safe_gt = torch.where(mask, gt, 1.0)
    safe_pred = torch.where(mask, pred, 1.0)

    def mmean(x):
        return (x * m).sum(dims) / cnt

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    d1 = mmean(thresh < 1.25)
    d2 = mmean(thresh < 1.25**2)
    d3 = mmean(thresh < 1.25**3)

    diff = safe_gt - safe_pred
    rms = torch.sqrt(mmean(diff**2))
    log_diff = torch.log(safe_gt) - torch.log(safe_pred)
    log_rms = torch.sqrt(mmean(log_diff**2))

    abs_rel = mmean(diff.abs() / safe_gt)
    sq_rel = mmean(diff**2 / safe_gt)

    err = torch.log(safe_pred) - torch.log(safe_gt)
    # max(., 0): the two f32 means may cross by an ulp where err is constant.
    silog = torch.sqrt((mmean(err**2) - mmean(err) ** 2).clamp_min(0.0)) * 100

    log10 = mmean((torch.log10(safe_pred) - torch.log10(safe_gt)).abs())

    metrics = torch.stack([silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3], dim=-1)
    return metrics * valid[..., None], valid
