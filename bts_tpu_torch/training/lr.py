"""Learning-rate schedules: ``bts_tpu/training/lr.py``.

Reference: manual polynomial decay each step (pytorch/bts_main.py:456-458):
    lr = (lr0 - end_lr) * (1 - step/total)^0.9 + end_lr
and TF's tf.train.polynomial_decay(power=0.9) (tensorflow/bts_main.py:136-139).
"""

from __future__ import annotations

import torch


def polynomial_decay(base_lr: float, end_lr: float, total_steps: int, power: float = 0.9):
    """step -> lr as a 0-dim f32 tensor, computed in f32 in ``bts_tpu``'s
    (optax's) order, so the optimizer applies the same f32 value."""

    def schedule(step: int) -> torch.Tensor:
        frac = 1.0 - torch.tensor(float(min(step, total_steps))) / torch.tensor(float(total_steps))
        return (base_lr - end_lr) * frac**power + end_lr

    return schedule


def polynomial_decay_host(base_lr: float, end_lr: float, total_steps: int, power: float = 0.9):
    """The same schedule as a Python float (double), for host-side logging."""

    def schedule(step: int) -> float:
        frac = 1.0 - min(step, total_steps) / total_steps
        return float((base_lr - end_lr) * frac**power + end_lr)

    return schedule
