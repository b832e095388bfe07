"""The numbers that decide ``correct``, each held to a limit of
``limits/<cell>.json``.

Depth maps: the mean relative gap of the program's depth to
the reference's over every pixel of the compared maps (``depth_absrel``,
the field's AbsRel with the reference as the truth), and the widest gap in
metres (``depth_max_m``).
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np


class Reservoir:
    """A uniform sample of ``size`` of the answers offered, whatever their
    number, drawn from ``seed``: the answers the check compares."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)
        self.items: list = []
        self.offered = 0

    def offer(self, make_item) -> None:
        """Keep the next answer with the sample's odds; ``make_item`` makes
        the kept copy only when it is kept."""
        n = self.offered
        self.offered += 1
        j = n if n < self.size else self.rng.randrange(n + 1)
        if j < self.size:
            if n < self.size:
                self.items.append(make_item())
            else:
                self.items[j] = make_item()


def depth_gaps(port: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    if port.shape != ref.shape:
        raise ValueError(f"depth maps of shapes {port.shape} and {ref.shape}")
    gap = np.abs(port - ref)
    if not np.isfinite(gap).all():
        return {"depth_absrel": float("inf"), "depth_max_m": float("inf")}
    return {"depth_absrel": float((gap / ref).mean()), "depth_max_m": float(gap.max())}


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit, in the order of ``limits``."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def all_held(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
