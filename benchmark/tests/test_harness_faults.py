"""Whole runs on the CPU at the tiny size, past the harness's look for a
card (``run.execute`` on the CPU), with the program's timed path sound and
then broken underneath: ``correct`` has to come out true, then false for
each fault the cell can have. The program runs in float32 here, so its
sound runs sit far under the cells' limits; the lower precision is the
control's (``test_harness_control.py``)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run, spec
from benchmark.tests.tiny import shrink

SECONDS = 0.5
SEED = 2**31 + 977


@pytest.fixture
def tiny(monkeypatch):
    shrink(monkeypatch)
    config = spec.config
    monkeypatch.setattr(spec, "config", lambda name: dict(config(name), compute_dtype="float32"))
    torch.manual_seed(0)


def execute(cell: str) -> dict:
    return run.execute(cell, SEED, SECONDS, False, torch.device("cpu"), t0=time.perf_counter())


# ---------------------------------------------------------------- serving

def serve_fault(kind):
    from bts_tpu_torch.apps import predict

    real = predict.forward_padded
    last = []

    def broken(model, image, focal):
        if kind == "half_batch":  # half the batch computed, its answers given to the rest
            b = image.shape[0] // 2
            return [torch.cat([o, o]) for o in real(model, image[:b], focal[:b])]
        outs = real(model, image, focal)
        if kind == "stale":  # the previous call's answers
            last.append(outs)
            return last[-2] if len(last) > 1 else outs
        outs[4] = outs[4].clone()
        outs[4][0] *= 1.1  # one image's depth altered as it is produced
        return outs

    return broken


@pytest.mark.parametrize("cell", ["nyu-d161-serve-b8", "kitti-rx101-serve-b8"])
def test_serve_sound(tiny, cell):
    result = execute(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("kind", ["stale", "half_batch", "altered"])
def test_serve_faults(tiny, monkeypatch, kind):
    from bts_tpu_torch.apps import predict

    monkeypatch.setattr(predict, "forward_padded", serve_fault(kind))
    assert not execute("nyu-d161-serve-b8")["correct"]
