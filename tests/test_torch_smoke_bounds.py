"""chip_smoke.py's work counts and bounds, on the CPU: the DenseNet161 layer
shapes of phase 3 and the least time the card could take for each kernel's
work (the ``bound_ms`` of its JSON line)."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


def test_phase3_shapes_are_first_and_last_layer_of_each_block():
    assert cs.densenet161_layer_shapes() == [
        (120, 160, 96), (120, 160, 336), (60, 80, 192), (60, 80, 720),
        (30, 40, 384), (30, 40, 2064), (15, 20, 1056), (15, 20, 2160),
    ]


@pytest.mark.parametrize("h,w,c,gflop,us,by", [
    (120, 160, 96, 31.1, 31.5, "operations"),
    (60, 80, 720, 17.0, 17.7, "bytes"),
    (15, 20, 2160, 2.4, 3.5, "bytes"),
])
def test_dense_layer_bound_at_batch_8(h, w, c, gflop, us, by):
    flops, nbytes = cs.dense_work(8, h, w, c)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.05)
    bound, bound_by = cs.bound_ms(flops, nbytes, "bfloat16")
    assert bound * 1e3 == pytest.approx(us, abs=0.05) and bound_by == by


def test_bounds_summed_over_phase3():
    dense = sum(cs.bound_ms(*cs.dense_work(8, h, w, c), "bfloat16")[0]
                for h, w, c in cs.densenet161_layer_shapes())
    assert dense == pytest.approx(0.125, abs=5e-4)
    lpg = sum(cs.lpg_bound(8, h, w, r)[0] for r, h, w in cs.NYU_SITES)
    # 12.9 MB of planes read and 29.5 MB of depth written at 3.35 TB/s
    assert lpg == pytest.approx(42.4e6 / 3.35e12 * 1e3, rel=2e-3)
    assert cs.lpg_bound(8, 60, 80, 8)[1] == "bytes"
