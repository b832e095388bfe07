"""Rematerialisation: ``bts_tpu``'s ``--remat`` (``bts_tpu/models/bts.py:83-98``)
as non-reentrant checkpoint regions of ``torch.utils.checkpoint``.

A region's forward keeps none of the tensors its backward needs; the first
backward node that reads one runs the region's forward again (the
recompute) and takes them from there. ``BTSModel`` makes the encoder one
region and, under scope ``all``, the decoder a second; the five skips
between them stay saved.

- Policy ``conv`` (the encoder's default): a selective-checkpoint policy
  saves the output of every convolution op and recomputes the rest (BN,
  ReLU, concat, pool, autocast's casts), as ``bts_tpu``'s
  ``save_only_these_names("conv_out")`` over the tags it puts on every conv
  output (``bts_tpu/models/layers.py:64-70``). The recompute then runs no
  convolution.
- Policy ``full``, and the decoder always (as ``bts_tpu``'s): nothing saved.
  The decoder's LPG forward kernel, launched through ctypes, is invisible to a
  dispatch policy anyway; its recompute launches it again.

``bts_tpu``'s recompute is functional: the batch statistics come out of its
forward once. PyTorch's recompute runs each train-mode BN forward again,
which would update the running statistics a second time and count
``num_batches_tracked`` twice (``nn.BatchNorm2d`` and ``GlobalBatchNorm2d``
alike). So a recompute puts every BN buffer of the region back as it found
it, also when the checkpoint stops the recompute early: each statistic moves
once a step. The recompute's BN normalizes by the batch statistics, as the
forward did, so what it recomputes equals what the forward computed.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

POLICIES = ("conv", "full")
SCOPES = ("encoder", "all")


def _save_convolutions(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def records_grad(module: nn.Module) -> bool:
    """True when a forward of ``module`` would be recorded for a backward:
    grad mode on and some parameter requiring grad."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters())


def _bn_buffers(module: nn.Module) -> list:
    """The buffers a train-mode forward of ``module`` updates."""
    return [b for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.training
            and m.track_running_stats
            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]


@contextlib.contextmanager
def _bn_buffers_kept(module: nn.Module, recompute_context):
    """The recompute's context: ``recompute_context`` inside, and around it
    the BN buffers of ``module`` put back as they were, outside any dispatch
    mode of the policy (whose recompute must run the forward's ops alone)."""
    bufs = _bn_buffers(module)
    with torch.no_grad():
        kept = [b.clone() for b in bufs]
    try:
        with recompute_context:
            yield
    finally:
        with torch.no_grad():
            for b, k in zip(bufs, kept):
                b.copy_(k)


def checkpointed(module: nn.Module, *args, save_convolutions: bool = False):
    """``module(*args)`` as one checkpoint region that saves nothing of its
    own, or only its convolutions' outputs. Its recompute leaves the BN
    buffers of ``module`` as they were."""

    def contexts():
        forward_context, recompute_context = (
            create_selective_checkpoint_contexts(_save_convolutions) if save_convolutions
            else noop_context_fn())
        return forward_context, _bn_buffers_kept(module, recompute_context)

    # The model draws no random numbers: no RNG state to stash and restore.
    return checkpoint(module, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)
