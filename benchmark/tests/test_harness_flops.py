"""Work counted from the published shapes."""

from __future__ import annotations

import pytest

from benchmark import flops, spec


@pytest.mark.parametrize("config, h, w, gflop", [
    ("bts-nyu-densenet161", 480, 640, 242.96),
    ("bts-nyu-densenet161", 416, 544, 178.98),
    ("bts-kitti-resnext101", 352, 1216, 514.28),
])
def test_forward_gflop_per_image(config, h, w, gflop):
    assert flops.forward_flops(spec.config(config), 1, h, w) / 1e9 == pytest.approx(gflop, abs=5e-3)
    assert flops.forward_flops(spec.config(config), 4, h, w) == 4 * flops.forward_flops(
        spec.config(config), 1, h, w)


def test_dense_layer_work():
    c = spec.config("bts-nyu-densenet161")
    shapes = flops.dense_layer_shapes(c, 480, 640)
    assert len(shapes) == 78
    assert shapes[0] == (96, 120, 160) and shapes[5] == (96 + 5 * 48, 120, 160)
    assert shapes[6] == (192, 60, 80) and shapes[18] == (384, 30, 40)
    assert shapes[54] == (1056, 15, 20) and shapes[-1] == (1056 + 23 * 48, 15, 20)
    ops, nbytes = flops.dense_layer_work(c, 8, 480, 640, 2)[0]
    px = 8 * 120 * 160
    assert ops == 2 * px * (96 * 192 + 192 * 48 * 9)
    assert nbytes == 2 * (px * (96 + 48) + 96 * 192 + 192 * 48 * 9 + 2 * 96 + 2 * 192)


def test_peaks():
    p = flops.peak("NVIDIA H100 80GB HBM3")
    assert p["bf16_flop_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peak("cpu")
