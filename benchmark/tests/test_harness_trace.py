"""The reductions of a traced window, on a synthetic timeline."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import WINDOW, Timeline, union

MS = 1_000_000  # ns


def timeline():
    # A 100 ms window: kernels at 10-30 and 20-40 (overlapping), a copy at
    # 60-70, a kernel half outside the window; host spans around them.
    return Timeline([
        ("user_annotation", WINDOW, 0, 100 * MS),
        ("user_annotation", "bench/enqueue", 0, 50 * MS),
        ("user_annotation", "bench/readback", 50 * MS, 100 * MS),
        ("kernel", "conv", 10 * MS, 30 * MS),
        ("kernel", "taps_sm90_kernel<1>", 20 * MS, 40 * MS),
        ("gpu_memcpy", "Memcpy DtoH", 60 * MS, 70 * MS),
        ("kernel", "late", 95 * MS, 110 * MS),
        ("kernel", "before", -20 * MS, -10 * MS),
        ("gpu_user_annotation", "bench/enqueue", 10 * MS, 40 * MS),
        ("cpu_op", "aten::conv2d", 1 * MS, 2 * MS),
    ])


def test_union_and_busy():
    assert union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    t = timeline()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s() == pytest.approx(0.030 + 0.010 + 0.005)
    assert t.kernel_busy_s() == pytest.approx(0.030 + 0.005)
    assert len(t.kernels()) == 3 and len(t.device_ops) == 4
    assert [n for n, _, _ in t.kernels(("taps_sm90_kernel",))] == ["taps_sm90_kernel<1>"]


def test_breakdown():
    t = timeline()
    top = dict(t.top_device_ops())
    assert top["conv"] == pytest.approx(0.02) and top["late"] == pytest.approx(0.015)
    gaps = dict(t.idle_gaps())
    # idle 0-10 and 40-60 (enqueue open as each starts), 70-95 (readback open)
    assert gaps["bench/enqueue"] == pytest.approx(0.030)
    assert gaps["bench/readback"] == pytest.approx(0.025)


def test_one_window_span():
    with pytest.raises(ValueError):
        Timeline([("kernel", "k", 0, 1)])


def run_record(**counts):
    return SimpleNamespace(timeline=timeline(), counts=counts, window_s=0.1,
                           config=spec.config("bts-nyu-densenet161"),
                           traffic={"batch": 32}, counters={"taps_launches": 1, "eo_launches": 0},
                           peaks={"bf16_flop_per_s": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_readers():
    run = run_record(forwards=2, images=64)
    assert spec.reader("idle_pct.serve")(run) == pytest.approx(55.0)
    assert spec.reader("serve.kernel_ms_per_img")(run) == pytest.approx(35 / 64)
    assert spec.reader("serve.copy_ms_per_img")(run) == pytest.approx(10 / 64)
    gflop = 242.9570304e9 * 32
    assert spec.reader("mfu.serve")(run) == pytest.approx(100 * gflop * 2 / 0.1 / 989e12)
    # One taps kernel in the trace, but two forwards of 78 layers: no value.
    assert spec.reader("dense_layers.roofline_pct")(run) is None
    run.peaks = None
    assert spec.reader("mfu.serve")(run) is None


def test_dense_roofline_share():
    run = run_record(forwards=1)
    run.timeline.device_ops = [("kernel", "taps_sm90_kernel", 0, 1_000_000)] * 78
    run.counters = {"taps_launches": 78, "eo_launches": 0}
    share = spec.reader("dense_layers.roofline_pct")(run)
    assert 0 < share < 100  # 78 ms for one batch-32 forward's dense layers
