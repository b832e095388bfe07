"""Offline eval: ``bts_tpu/evaluation/offline.py`` in PyTorch -- a
checkpoint-directory watcher with an idempotency ledger.

Reference: pytorch/bts_eval.py:112-232 and tensorflow/bts_eval.py:104-335 --
enumerate the model-* checkpoints, skip the steps recorded in the
'evaluated_checkpoints' ledger, evaluate each against gt, log TensorBoard
scalars per step, append the ledger. The TF twin adds a checkpoint-maturity
guard (skip a file younger than 60 s, tensorflow/bts_eval.py:143-150),
included here. Checkpoints are the port's and the reference's ``.pth``
files (``training/checkpoint.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.metrics import EVAL_METRICS
from bts_tpu_torch.evaluation.online import run_online_eval
from bts_tpu_torch.training.checkpoint import list_step_checkpoints

LEDGER_NAME = "evaluated_checkpoints"


def eval_summary_writer(cfg: Config):
    """A tensorboardX writer for the eval scalars, in
    ``<eval_summary_directory>/<model_name>`` when that is set, else in
    ``<log_directory>/eval``; None when tensorboardX does not import."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    summary_dir = (os.path.join(cfg.eval_summary_directory, cfg.model_name)
                   if cfg.eval_summary_directory
                   else os.path.join(cfg.log_directory or ".", "eval"))
    return SummaryWriter(summary_dir, flush_secs=30)


def read_ledger(ckpt_dir: str) -> List[int]:
    path = os.path.join(ckpt_dir, LEDGER_NAME)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [int(s) for s in f.read().split() if s.strip()]


def append_ledger(ckpt_dir: str, step: int) -> None:
    with open(os.path.join(ckpt_dir, LEDGER_NAME), "a") as f:
        f.write(f"{step}\n")


def pending_checkpoints(ckpt_dir: str, maturity_secs: float = 60.0) -> Dict[int, str]:
    """Checkpoints not yet evaluated and older than maturity_secs."""
    done = set(read_ledger(ckpt_dir))
    now = time.time()
    out = {}
    for step, path in sorted(list_step_checkpoints(ckpt_dir).items()):
        if step in done:
            continue
        if now - os.path.getmtime(path) < maturity_secs:
            continue  # the TF maturity guard (tensorflow/bts_eval.py:143-150)
        out[step] = path
    return out


def evaluate_pending(cfg: Config, ckpt_dir: Optional[str] = None, maturity_secs: float = 60.0,
                     writer=None, device: Optional[torch.device] = None) -> Dict[int, np.ndarray]:
    """Evaluate every pending checkpoint on ``device`` (default the CUDA
    card); returns {step: measures}."""
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.convert import load_weights

    ckpt_dir = ckpt_dir or os.path.join(cfg.log_directory, cfg.model_name)
    pending = pending_checkpoints(ckpt_dir, maturity_secs)
    if not pending:
        return {}

    model = create_model(cfg).to(torch.device(device or "cuda"))
    results = {}
    for step, path in pending.items():
        model.load_state_dict(load_weights(path, model, cfg), strict=True)
        measures = run_online_eval(model, cfg)
        if measures is None:
            continue
        results[step] = measures
        if writer is not None:
            for i, name in enumerate(EVAL_METRICS):
                writer.add_scalar(name, float(measures[i]), step)
            writer.flush()
        append_ledger(ckpt_dir, step)
    return results
