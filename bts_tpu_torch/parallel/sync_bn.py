"""Global-batch BatchNorm for data parallelism.

``bts_tpu`` trains BN over the whole (global) batch, since its step is one
program over the mesh (``bts_tpu/models/layers.py:303-325``): per channel,
the mean and the mean of squares over (B, H, W) in f32, the variance as
their difference, and the running variance updated with the Bessel factor
n/(n-1) of the global count n. ``GlobalBatchNorm2d`` computes the same
across ranks: each rank's per-channel sums and count are added over the
process group by an all-reduce that autograd differentiates through (its
backward all-reduces the incoming gradients), so the backward sees the
global terms too.

The sums are taken about a shift, the global mean (one all-reduce of the
plain sums, outside autograd): the variance is the same function of the
inputs for any shift, while the mean of squares about zero loses the
variance to cancellation in f32 when a channel's mean is large against its
spread (and its gradient with it). Eval mode, and BN frozen in a train-mode
model (``bn_no_track_stats``, the TF graph: ``training/state.py``'s
``set_bn_mode``), run ``nn.BatchNorm2d``'s own forward and never
communicate. ``torch.nn.SyncBatchNorm`` is not used: its forward refuses
CPU tensors, and the CPU tests must run the code the card runs.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from bts_tpu_torch.parallel.mesh import all_reduce_sum


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same parameters, buffers and state-dict keys)
    whose train-mode statistics are those of the global batch over
    ``group``; with ``group`` None, this process's batch."""

    def __init__(self, *args, group: Optional[object] = None, **kw):
        super().__init__(*args, **kw)
        self.group = group

    def __deepcopy__(self, memo):
        # A copy (a serving replica, say) shares the process group, which
        # cannot be copied, and copies the rest.
        memo[id(self.group)] = self.group
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        return global_batch_norm(x, self, self.group)


def _all_reduce(t: torch.Tensor, group, differentiable: bool) -> torch.Tensor:
    if group is None:
        return t
    if differentiable:
        return all_reduce_sum(t, group)
    dist.all_reduce(t, group=group)
    return t


def global_batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, group=None) -> torch.Tensor:
    """Train-mode BN of NCHW ``x`` with the statistics of the global batch
    over ``group`` (None: ``x`` alone), updating ``bn``'s running statistics
    as ``nn.BatchNorm2d`` does (momentum, or the cumulative average when it
    is None). Statistics and normalization in f32; the output in ``x``'s
    dtype."""
    c = x.shape[1]
    dims = (0, 2, 3)
    x32 = x.float()
    with torch.no_grad():
        plain = torch.cat([x32.sum(dims), x32.new_full((1,), x.numel() // c)])
        plain = _all_reduce(plain, group, differentiable=False)
        n = plain[c]
        shift = plain[:c] / n
    xc = x32 - shift[None, :, None, None]
    sums = _all_reduce(torch.cat([xc.sum(dims), (xc * xc).sum(dims)]), group,
                       differentiable=True)
    mean_c = sums[:c] / n
    var = sums[c:] / n - mean_c * mean_c
    mean = shift + mean_c
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            factor = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                      else bn.momentum)
            bessel = torch.where(n > 1, n / (n - 1), torch.ones_like(n))
            bn.running_mean.mul_(1 - factor).add_(mean.detach() * factor)
            bn.running_var.mul_(1 - factor).add_(var.detach() * bessel * factor)
    y = (x32 - mean[None, :, None, None]) * torch.rsqrt(var + bn.eps)[None, :, None, None]
    if bn.affine:
        y = y * bn.weight[None, :, None, None] + bn.bias[None, :, None, None]
    return y.to(x.dtype)


def convert_global_bn(module: nn.Module, group=None) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` under ``module`` a ``GlobalBatchNorm2d``
    over ``group`` (the default group when None), in place, when the group
    holds more than one rank. The new modules take the old ones' parameter
    and buffer objects (an optimizer made before keeps working), their mode
    and their names. Returns ``module``."""
    if not (dist.is_available() and dist.is_initialized()):
        return module
    group = group or dist.group.WORLD
    if dist.get_world_size(group) <= 1:
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is nn.BatchNorm2d:
                setattr(parent, name, _global_copy(child, group))
    return module


def _global_copy(bn: nn.BatchNorm2d, group) -> GlobalBatchNorm2d:
    new = GlobalBatchNorm2d(bn.num_features, bn.eps, bn.momentum, bn.affine,
                            bn.track_running_stats, group=group)
    if bn.affine:
        new.weight, new.bias = bn.weight, bn.bias
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        setattr(new, name, getattr(bn, name))
    new.train(bn.training)
    return new
