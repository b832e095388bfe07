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


def test_f32_peak_is_3xtf32_on_the_tensor_cores():
    """f32-accurate products run as three TF32 products: 494.7 / 3 TFLOP/s."""
    assert cs.PEAK_FLOPS["float32"] == pytest.approx(494.7e12 / 3)


def test_f32_dense_bound_summed_over_phase3():
    """The 8 shapes at B=8 in f32: 118.6 GFLOP (hand count: 2 * B*H*W *
    (C*192 + 9*192*48) per shape), three TF32 products each at 494.7
    TFLOP/s; every shape bound by operations, also with 4-byte elements."""
    shapes = cs.densenet161_layer_shapes()
    flops = sum(2 * 8 * h * w * (c * 192 + 9 * 192 * 48) for h, w, c in shapes)
    assert flops / 1e9 == pytest.approx(118.6, abs=0.05)
    bounds = [cs.bound_ms(*cs.dense_work(8, h, w, c, esize=4), "float32") for h, w, c in shapes]
    assert all(by == "operations" for _, by in bounds)
    assert sum(b for b, _ in bounds) == pytest.approx(flops * 3 / 494.7e12 * 1e3, rel=1e-9)
    assert sum(b for b, _ in bounds) == pytest.approx(0.72, abs=5e-3)


def test_lpg_bound_with_bf16_out():
    """12.9 MB of planes read and 14.7 MB of bf16 depth written at 3.35 TB/s."""
    planes = sum(8 * h * w * 16 for _, h, w in cs.NYU_SITES)
    depth = sum(8 * h * r * w * r * 2 for r, h, w in cs.NYU_SITES)
    assert (planes, depth) == (12_902_400, 14_745_600)
    lpg = sum(cs.lpg_bound(8, h, w, r, out_esize=2)[0] for r, h, w in cs.NYU_SITES)
    assert lpg == pytest.approx((planes + depth) / 3.35e12 * 1e3, rel=1e-9)
    assert lpg * 1e3 == pytest.approx(8.25, abs=0.01)


def test_eo_work_is_four_thirds_of_the_taps_3x3():
    """The eo form multiplies the whole packed (3, 4*Cmid, 2G) kernel, zero
    blocks included: its 3x3 is 4/3 of the taps form's (12 against 9 *
    Cmid * G MACs a pixel) and its 1x1 the same, summed over the phase-3
    shapes at B=8; it reads 24 * Cmid * G weights against 9."""
    shapes = cs.densenet161_layer_shapes()
    one = sum(2 * 8 * h * w * c * 192 for h, w, c in shapes)
    taps = sum(cs.dense_work(8, h, w, c)[0] for h, w, c in shapes)
    eo = sum(cs.dense_work(8, h, w, c, eo=True)[0] for h, w, c in shapes)
    assert eo - one == pytest.approx(4 / 3 * (taps - one), rel=1e-12)
    assert (eo - taps) / 1e9 == pytest.approx(2 * 8 * 51_000 * 3 * 192 * 48 / 1e9, rel=1e-12)
    for esize in (2, 4):
        nbytes = cs.dense_work(8, 15, 20, 2160, esize=esize, eo=True)[1]
        assert nbytes - cs.dense_work(8, 15, 20, 2160, esize=esize)[1] == esize * 15 * 192 * 48


@pytest.mark.parametrize("dtype,ms,by_bytes", [("bfloat16", 0.14668, 3), ("float32", 0.85603, 0)])
def test_eo_bound_summed_over_phase3(dtype, ms, by_bytes):
    """eo's bound on its own work over the 8 shapes at B=8: every shape
    bound by operations but, in bf16, the last of 30x40 and both of 15x20
    (bytes)."""
    esize = 2 if dtype == "bfloat16" else 4
    bounds = [cs.bound_ms(*cs.dense_work(8, h, w, c, esize=esize, eo=True), dtype)
              for h, w, c in cs.densenet161_layer_shapes()]
    assert sum(b for b, _ in bounds) == pytest.approx(ms, abs=5e-6)
    assert [by for _, by in bounds].count("bytes") == by_bytes


def test_densenet121_phase3_shapes():
    """DenseNet121: stem 64, growth 32, blocks (6, 12, 24, 16)."""
    assert cs.densenet_layer_shapes("densenet121") == [
        (120, 160, 64), (120, 160, 224), (60, 80, 128), (60, 80, 480),
        (30, 40, 256), (30, 40, 992), (15, 20, 512), (15, 20, 992),
    ]
    assert cs.densenet_layer_shapes("densenet161") == cs.densenet161_layer_shapes()


def test_lpg_backward_bound_at_the_train_sites():
    """Batch 4 at 416x544: the bf16 gradient (4*416*544*2 bytes a site) read
    once, the planes read and the result written (16 bytes each a cell)."""
    grad = 3 * 4 * 416 * 544 * 2
    cells = sum(4 * h * w for _, h, w in cs.TRAIN_SITES)
    assert cells == 4 * 416 * 544 * (1 / 64 + 1 / 16 + 1 / 4)
    total = sum(cs.lpg_backward_bound(4, h, w, r, 2)[0] for r, h, w in cs.TRAIN_SITES)
    assert total == pytest.approx((grad + 32 * cells) / 3.35e12 * 1e3, rel=1e-9)
    assert total * 1e3 == pytest.approx(4.46, abs=0.01)
    assert all(cs.lpg_backward_bound(4, h, w, r, 2)[1] == "bytes" for r, h, w in cs.TRAIN_SITES)


def test_train_args_drop_only_the_online_eval_lines(tmp_path):
    path, overrides = cs.train_args(str(tmp_path), str(tmp_path / "d" / "files.txt"),
                                    str(tmp_path / "logs"))
    kept = [ln.split()[0] for ln in open(path) if ln.split()]
    full = [ln.split()[0] for ln in open(os.path.join(ROOT, "configs", "arguments_train_nyu.txt"))
            if ln.split()]
    assert kept == [f for f in full if f not in cs.ONLINE_EVAL_FLAGS]
    assert "--do_online_eval" in full and "--device_augment" in kept
    assert overrides[overrides.index("--num_epochs") + 1] == "1"
