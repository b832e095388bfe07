"""Scale-invariant log (silog) loss: ``bts_tpu/training/loss.py``.

Reference: pytorch/bts.py:41-48 --
    d = log(pred[mask]) - log(gt[mask])
    loss = sqrt(mean(d^2) - variance_focus * mean(d)^2) * 10

As in ``bts_tpu``, boolean indexing is replaced by masked means, which give
the same value for any mask with at least one valid element and need no
host sync for the mask's size. Under data parallelism (``group``) the three
sums are added over the ranks before the square root, so every rank computes
the global batch's loss (``bts_tpu/training/loss.py:31-39`` over its mesh).
"""

from __future__ import annotations

import torch

from bts_tpu_torch.parallel.mesh import all_reduce_sum


def silog_loss(
    depth_est: torch.Tensor,
    depth_gt: torch.Tensor,
    mask: torch.Tensor,
    variance_focus: float = 0.85,
    group=None,
) -> torch.Tensor:
    """Masked silog loss, a scalar in f32 whatever the inputs' dtype.

    ``mask`` is boolean (or {0,1}), the shape of ``depth_est``; the reference
    builds it as depth_gt > 0.1 (NYU) / > 1.0 (KITTI)
    (pytorch/bts_main.py:449-452). ``count = max(sum(mask), 1)``, and the log
    of masked-out (possibly zero) entries is guarded: they get weight 0.
    With a process ``group``, Σd, Σd² and the count are all-reduced (an
    all-reduce autograd differentiates through) before the means.
    """
    m = mask.float()
    valid = m > 0
    one = torch.ones((), dtype=torch.float32, device=depth_est.device)
    safe_est = torch.where(valid, depth_est.float(), one)
    safe_gt = torch.where(valid, depth_gt.float(), one)
    d = (torch.log(safe_est) - torch.log(safe_gt)) * m
    sum_d2, sum_d, count = (d * d).sum(), d.sum(), m.sum()
    if group is not None:
        sum_d2, sum_d, count = all_reduce_sum(torch.stack([sum_d2, sum_d, count]), group)
    count = torch.clamp(count, min=1.0)
    mean_d2 = sum_d2 / count
    mean_d = sum_d / count
    return torch.sqrt(mean_d2 - variance_focus * mean_d * mean_d) * 10.0
