"""The LPG implementations' time per call on the card: ``python -m bts_tpu_torch.tools.bench_lpg``.

The port's counterpart of ``scripts/bench_lpg.py``: the same six cases, the
decoder's plane grids at NYU eval 480x640 and train crop 416x544, one
(upratio, grid) per LPG site, at batch 16, with the script's plane draws from
``np.random.default_rng(0)``. The implementations keep the script's names:
``xla``, the plain PyTorch version, and ``pallas``, the CUDA kernels
(``ops/lpg_cuda.py``), forward and forward + backward (the gradient of
``sum(lpg(q) ** 2)``).

Method, the script's: a chain of K dependent applications (``carry + 1e-30 *
sum(lpg(carry))``, or ``carry + 1e-30 * grad``) timed at K1 = 64 and K2 = 512,
the best of 5 runs each, and the time per application is ``(t(K2) - t(K1)) /
(K2 - K1)``, so that constant costs cancel. The script chains inside one
``lax.scan``; eager PyTorch would spend more time launching the 3-4 kernels
of an application than the card spends in them, so each chain is captured
once as a CUDA graph and its replays are timed by CUDA events (``"method":
"cuda_graph"``; a capture that fails raises); on the CPU (tests) chains run
eagerly on the host clock (``"method": "host"``).

Each row: ``{"upratio", "grid", "batch", "xla_fwd_us", "xla_fwdbwd_us",
"pallas_fwd_us", "pallas_fwdbwd_us", "fwd_roofline_us", "method"}``.
``fwd_roofline_us`` is the forward's bytes (planes read, map written, map
read again by the chain's sum) over 3.35 TB/s, the HBM rate of one NVIDIA
H100 SXM (the script's 819 GB/s was a TPU v5e's). On the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from bts_tpu_torch.cli.test import resolve_device
from bts_tpu_torch.ops.lpg import local_planar_guidance
from bts_tpu_torch.tools import benchtools

K1, K2 = 64, 512
REPS = 5
B = 16
CASES = [
    # (upratio, H, W): decoder plane grids at 480x640 and 416x544.
    (8, 60, 80),
    (4, 120, 160),
    (2, 240, 320),
    (8, 52, 68),
    (4, 104, 136),
    (2, 208, 272),
]
IMPLS = ("xla", "pallas")
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3 (chip_smoke.py's)


def seeded_planes(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """The script's plane draw: unit-ish normals, positive n3 and n4."""
    raw = rng.normal(size=(B, h, w, 4)).astype(np.float32)
    raw[..., 2] = np.abs(raw[..., 2]) + 0.5
    raw[..., 3] = np.abs(raw[..., 3]) + 0.5
    return raw


def fwd_step(r: int, impl: str):
    def step(carry):
        return carry + 1e-30 * local_planar_guidance(carry, r, impl=impl).sum()

    return step


def fwdbwd_step(r: int, impl: str):
    def step(carry):
        q = carry.detach().requires_grad_()
        (grad,) = torch.autograd.grad((local_planar_guidance(q, r, impl=impl) ** 2).sum(), q)
        return carry + 1e-30 * grad

    return step


def chain(step, pe: torch.Tensor, k: int) -> torch.Tensor:
    carry = pe
    for _ in range(k):
        carry = step(carry)
    return carry.sum()


def time_graph(step, pe: torch.Tensor, k: int) -> float:
    """Best of REPS replays of the chain captured as one CUDA graph, seconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs want
        chain(step, pe, 2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(step, pe, k)
    graph.replay()
    best = math.inf
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del graph
    return best


def time_host(step, pe: torch.Tensor, k: int) -> float:
    """Best of REPS runs of the chain, seconds, on the host clock around its
    readback (the CPU)."""
    chain(step, pe, 2).item()
    best = math.inf
    for _ in range(REPS):
        t0 = time.perf_counter()
        chain(step, pe, k).item()
        best = min(best, time.perf_counter() - t0)
    return best


def per_application_us(step, pe: torch.Tensor) -> float:
    """(t(K2) - t(K1)) / (K2 - K1) in us: CUDA graph replays on a card, the
    host clock on the CPU."""
    timer = time_graph if pe.is_cuda else time_host
    return (timer(step, pe, K2) - timer(step, pe, K1)) / (K2 - K1) * 1e6


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    benchtools.device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    records = []
    for r, h, w in CASES:
        pe = torch.from_numpy(seeded_planes(rng, h, w)).to(device)
        row = {"upratio": r, "grid": f"{h}x{w}", "batch": B}
        for impl in IMPLS:
            for kind, make in (("fwd", fwd_step), ("fwdbwd", fwdbwd_step)):
                row[f"{impl}_{kind}_us"] = round(per_application_us(make(r, impl), pe), 3)
        out_bytes = B * h * w * (4 + 2 * r * r) * 4
        row["fwd_roofline_us"] = round(out_bytes / HBM_BYTES_PER_S * 1e6, 3)
        row["method"] = "cuda_graph" if pe.is_cuda else "host"
        records.append(benchtools.emit(device, row))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
