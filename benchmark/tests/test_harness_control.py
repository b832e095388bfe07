"""The lower-precision control (the reference with float8 convolutions in
the program's place) fails each cell's limits, at the tiny size on the CPU. At the cells' own sizes on a card:
``python3 -m benchmark.controls --workload <cell> --seeds ...``."""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, controls, spec
from benchmark.tests.tiny import shrink

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_limits(monkeypatch, cell):
    shrink(monkeypatch)
    limits = spec.limits(cell)
    out = controls.readings(cell, 2**31 + 7, torch.device("cpu"))
    for stand_in, numbers in out.items():
        assert not compare.all_held(compare.held(numbers, limits)), (stand_in, numbers)
