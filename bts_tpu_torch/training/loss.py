"""Scale-invariant log (silog) loss: ``bts_tpu/training/loss.py``.

Reference: pytorch/bts.py:41-48 --
    d = log(pred[mask]) - log(gt[mask])
    loss = sqrt(mean(d^2) - variance_focus * mean(d)^2) * 10

As in ``bts_tpu``, boolean indexing is replaced by masked means, which give
the same value for any mask with at least one valid element and need no
host sync for the mask's size.
"""

from __future__ import annotations

import torch


def silog_loss(
    depth_est: torch.Tensor,
    depth_gt: torch.Tensor,
    mask: torch.Tensor,
    variance_focus: float = 0.85,
) -> torch.Tensor:
    """Masked silog loss, a scalar in f32 whatever the inputs' dtype.

    ``mask`` is boolean (or {0,1}), the shape of ``depth_est``; the reference
    builds it as depth_gt > 0.1 (NYU) / > 1.0 (KITTI)
    (pytorch/bts_main.py:449-452). ``count = max(sum(mask), 1)``, and the log
    of masked-out (possibly zero) entries is guarded: they get weight 0.
    """
    m = mask.float()
    count = torch.clamp(m.sum(), min=1.0)
    valid = m > 0
    one = torch.ones((), dtype=torch.float32, device=depth_est.device)
    safe_est = torch.where(valid, depth_est.float(), one)
    safe_gt = torch.where(valid, depth_gt.float(), one)
    d = (torch.log(safe_est) - torch.log(safe_gt)) * m
    mean_d2 = (d * d).sum() / count
    mean_d = d.sum() / count
    return torch.sqrt(mean_d2 - variance_focus * mean_d * mean_d) * 10.0
