"""Continuous eval: ``bts_tpu/evaluation/schedule.py`` in PyTorch.

Reference: {pytorch,tensorflow}/run_bts_eval_schedule.py:19-47 -- an
APScheduler loop shelling out to bts_eval every minute on a pinned GPU (the
"train on devices 1..N, eval on device 0" workflow). Here a plain interval
loop calls ``evaluate_pending`` in this process (no scheduler, no
subprocess), on the device the caller names.
"""

from __future__ import annotations

import time
import traceback
from typing import Optional

import torch

from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.offline import evaluate_pending


def run_schedule(cfg: Config, interval_secs: float = 60.0, max_iterations: int = 0, writer=None,
                 device: Optional[torch.device] = None) -> None:
    """Evaluate pending checkpoints every interval_secs. max_iterations=0
    runs forever (the reference's BlockingScheduler)."""
    i = 0
    while True:
        try:
            results = evaluate_pending(cfg, writer=writer, device=device)
            if results:
                print(f"Evaluated checkpoints: {sorted(results)}")
        except Exception:
            traceback.print_exc()
        i += 1
        if max_iterations and i >= max_iterations:
            return
        time.sleep(interval_secs)
