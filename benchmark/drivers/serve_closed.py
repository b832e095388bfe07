"""Closed-loop serving, as ``cli.test`` dumps depth maps: each call is
``apps/predict.run_predictions``'s step for one batch. The host batch, a
float32 NHWC array as the loader hands it, goes to the card
(``torch.from_numpy(...).permute(0, 3, 1, 2).to(device)``, its focals
likewise); ``forward_padded`` runs under ``inference_mode`` and the
dumper's ``compute_context``; all five outputs come back to the host
synchronously (``o[:, 0].cpu().numpy()``) and the depth is checked finite.
Only the dumper's png writing is left out.

Mix parameters: ``batch``, ``pool`` (distinct seeded host batches, used in
turn), ``check_calls`` (calls kept for the correctness check, a uniform
sample of those completed, drawn from the seed).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, program
from benchmark.reference.model import IMAGENET_MEAN, IMAGENET_STD, no_tf32
from benchmark.weights import reference_model, seeded_state_dict

WARMUP_CALLS = 2
REFERENCE_ROWS = 8  # images a reference forward takes at once


def seeded_batches(config: dict, batch: int, pool: int, seed: int,
                   device: torch.device) -> List[np.ndarray]:
    """``pool`` host batches of frames in [0, 1], normalized as the dumper's
    loader normalizes them: float32 NHWC numpy arrays, drawn on the device
    from the seed and copied to the host once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5EED)
    h, w = config["input_height"], config["input_width"]
    kw = dict(dtype=torch.float32, device=device)
    mean, std = torch.tensor(IMAGENET_MEAN, **kw), torch.tensor(IMAGENET_STD, **kw)
    return [((torch.rand(batch, h, w, 3, generator=gen, **kw) - mean) / std).cpu().numpy()
            for _ in range(pool)]


def reference_depth(model, image: np.ndarray, focal: float, device: torch.device) -> np.ndarray:
    """The reference's depth maps of one host batch, ``REFERENCE_ROWS`` at a time."""
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    f = torch.full((REFERENCE_ROWS,), focal, dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for r in range(0, x.shape[0], REFERENCE_ROWS):
            rows = x[r:r + REFERENCE_ROWS].contiguous().to(device)
            out.append(model(rows, f[:rows.shape[0]])[:, 0].cpu())
    return torch.cat(out).numpy()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from bts_tpu_torch.apps.predict import compute_context, forward_padded

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.batch = traffic["batch"]
        self.cfg = program.port_config(config, seed)
        self.model = program.port_model(config, seeded_state_dict(config, seed, device),
                                        device).eval()
        self.images = seeded_batches(config, self.batch, traffic["pool"], seed, device)
        self.focal = np.full((self.batch,), config["focal"], dtype=np.float32)
        self._context = lambda: compute_context(self.cfg, device)
        self._forward = forward_padded
        self.kept = compare.Reservoir(traffic["check_calls"], seed)  # (pool slot, depth)
        for i in range(WARMUP_CALLS):
            self._call(i)

    def _call(self, i: int):
        """One batch of the dumper: (pool slot, depth maps, all finite)."""
        slot = i % len(self.images)
        with record_function("bench/h2d"):
            image = torch.from_numpy(self.images[slot]).permute(0, 3, 1, 2).to(self.device)
            focal = torch.from_numpy(self.focal).to(self.device)
        with record_function("bench/forward"):
            with torch.inference_mode(), self._context():
                outs = self._forward(self.model, image, focal)
        with record_function("bench/readback"):
            *_, depth = [o[:, 0].cpu().numpy() for o in outs]
            finite = bool(np.isfinite(depth).all())
        return slot, depth, finite

    def window(self, seconds: float) -> dict:
        calls = failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            slot, depth, finite = self._call(calls)
            self.kept.offer(lambda: (slot, depth))
            failed += not finite
            calls += 1
        elapsed = time.perf_counter() - t0
        images = calls * self.batch
        return {"metrics": {"img_per_s": images / elapsed},
                "counts": {"images": images, "forwards": calls},
                "attempted": images, "failed": failed * self.batch, "elapsed_s": elapsed}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The compared numbers, against the plain reference."""
        no_tf32()
        model = reference_model(self.config, self.seed, self.device).eval()
        refs = {slot: reference_depth(model, self.images[slot], self.config["focal"], self.device)
                for slot in sorted({slot for slot, _ in self.kept.items})}
        port = np.stack([d for _, d in self.kept.items])
        return compare.depth_gaps(port, np.stack([refs[slot] for slot, _ in self.kept.items]))
