"""What the port's benchmark tools share (``tools/bench*.py``).

- ``device_arg``: ``--device``, the CUDA card unless ``--device cpu`` asks
  for the CPU (tests); the tools resolve it with ``cli.test``'s
  ``resolve_device``, so no card and no ``--device cpu`` raises, with no
  quiet fallback to the CPU.
- ``seeded_images``: the JAX scripts' inputs, ``np.random.default_rng(0)``'s
  draws in their order, moved to NCHW on the device as ``cli.test`` moves a
  batch (``apps/predict.py``).
- ``pipelined``: the JAX scripts' timed loop (``bench.py``,
  ``scripts/bench_train.py``): results read back ``delay`` calls late, so the
  host enqueues ahead of the card, timed on the host clock; a value read
  back that is not finite raises.
- ``card`` / ``emit``: each JSON result is printed after a line with the
  card's name and power limit, as ``nvidia-smi`` gives them (none on the CPU).
- ``profiled``: ``--profile_dir``, a ``torch.profiler`` Chrome trace of the
  timed loop (``tools/profile_forward.py`` makes the tables).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, List

import numpy as np
import torch

FOCAL = 518.8579  # NYU's focal length, the JAX scripts' jnp.full(..., 518.8579)


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="",
                        help="torch device; default 'cuda' (fails without a card). "
                        "'cpu' runs the plain PyTorch ops, for tests.")


def seeded_images(batch: int, h: int, w: int, device: torch.device, n: int = 2
                  ) -> List[torch.Tensor]:
    """``n`` draws of ``default_rng(0).normal(size=(batch, h, w, 3))`` in f32,
    each as an NCHW view of the NHWC array on ``device``."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(batch, h, w, 3)).astype(np.float32))
            .permute(0, 3, 1, 2).to(device) for _ in range(n)]


def focal(batch: int, device: torch.device) -> torch.Tensor:
    return torch.full((batch,), FOCAL, dtype=torch.float32, device=device)


def read_back(result: torch.Tensor) -> float:
    """The 0-d tensor's value; a timed call that is not finite raises."""
    value = result.item()
    if not math.isfinite(value):
        raise FloatingPointError(f"a timed call returned {value}")
    return value


def pipelined(fn: Callable[[int], torch.Tensor], iters: int, delay: int) -> float:
    """Seconds, host clock, of ``fn(0) .. fn(iters - 1)``: each returns a 0-d
    device tensor, read back ``delay`` calls later (``read_back``); the last
    ``delay`` are read back at the end, inside the timing."""
    pending = collections.deque()
    t0 = time.perf_counter()
    for i in range(iters):
        pending.append(fn(i))
        if len(pending) > delay:
            read_back(pending.popleft())
    while pending:
        read_back(pending.popleft())
    return time.perf_counter() - t0


def card(device: torch.device):
    """``name, power limit`` of the card from nvidia-smi; None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def emit(device: torch.device, record: dict) -> dict:
    """Print the card's line (on a card) and then ``record`` as one JSON line."""
    line = card(device)
    if line is not None:
        print(line)
    print(json.dumps(record), flush=True)
    return record


@contextlib.contextmanager
def profiled(profile_dir: str, device: torch.device):
    """Trace the block with ``torch.profiler`` into ``<profile_dir>/trace.json``
    (Chrome format); nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace -> {path}", file=sys.stderr, flush=True)
