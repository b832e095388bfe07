"""NeWCRFs through the harness as files of its own (``models/newcrfs.py``,
``reference/newcrfs.py``): a whole tiny CPU run of its cell is correct, and
not with a stale answer; its seeded weights keep the rules of
``weights.py``; its forward FLOPs equal a hand count; the float8 control
reaches its linear layers; the window attention's calls and work at the
published size; the kernel metrics' readers on a synthetic trace; its
reference and model file load nothing of the program."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import flops, run, spec, weights
from benchmark.models import newcrfs
from benchmark.reference.lowp import fp8_round, set_quant
from benchmark.tests.tiny import shrink, tiny_config
from benchmark.trace import WINDOW, Timeline

CPU = torch.device("cpu")
CELL = "nyu-newcrfs-serve-b8"
CONFIG = spec.config("newcrfs-nyu-swinl07")
TINY = tiny_config(CONFIG)
SEED = 2**31 + 2003
ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("fault", [None, "stale"])
def test_tiny_run(monkeypatch, fault):
    shrink(monkeypatch)
    config = spec.config
    monkeypatch.setattr(spec, "config", lambda name: dict(config(name), compute_dtype="float32"))
    if fault:
        from bts_tpu_torch.apps import predict

        real, last = predict.forward_padded, []

        def stale(model, image, focal):  # the previous call's answers
            last.append(real(model, image, focal))
            return last[-2] if len(last) > 1 else last[-1]

        monkeypatch.setattr(predict, "forward_padded", stale)
    result = run.execute(CELL, SEED, 0.5, False, CPU, t0=time.perf_counter())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] == (fault is None), result["checks"]


@pytest.mark.parametrize("config", [CONFIG, TINY], ids=["published", "tiny"])
def test_config_is_the_programs(config):
    """The widths the program is built from, and what it fixes as upstream
    does (window 7, two blocks a CRF level, the pool scales, the MLP ratio,
    the patch), are the configuration's."""
    from bts_tpu_torch.models import newcrfs as program
    from bts_tpu_torch.models.encoders import swin

    bb, dec = config["backbone"], config["decoder"]
    assert bb["window_size"] == dec["crf_window"] == program.WINDOW
    assert dec["crf_depth"] == program.CRF_DEPTH
    assert tuple(dec["pool_scales"]) == program.POOL_SCALES
    assert bb["mlp_ratio"] == swin.MLP_RATIO and bb["patch_size"] == swin.PATCH
    assert dec["v_dims"] == [d // 4 for d in dec["crf_dims"][1:]] + [dec["channels"]]
    if config is CONFIG:
        widths = newcrfs.port_widths(config)
        assert widths.pop("max_depth") == 10.0
        assert widths == program.VERSIONS[config["encoder"]]


def test_seeded_weights_follow_the_rules():
    a, b = weights.seeded_state_dict(TINY, 5, CPU), weights.seeded_state_dict(TINY, 5, CPU)
    built = newcrfs.reference(TINY).state_dict()
    computed = [k for k in built if k.endswith("relative_position_index")]
    assert len(computed) == 8 + 8 and list(a) == [k for k in built if k not in computed]
    for k in a:
        assert torch.equal(a[k], b[k])
    qkv = "backbone.layers.0.blocks.0.attn.qkv.weight"
    bound = math.sqrt(6.0 / (32 + 96))
    assert 0.9 * bound < a[qkv].abs().max() <= bound  # Linear: Xavier-uniform
    tables = [a[k] for k in a if k.endswith("relative_position_bias_table")]
    flat = torch.cat([t.flatten() for t in tables])
    # A normal of std 0.02 (truncated at -2 and 2, as Swin's and timm's, which it never reaches).
    assert abs(flat.std().item() - 0.02) < 0.002 and abs(flat.mean().item()) < 0.002
    for k in ("backbone.norm0.weight", "crf0.norm_crf.weight", "decoder.psp_modules.0.1.gn.weight",
              "decoder.bottleneck.bn.weight", "decoder.bottleneck.bn.running_var"):
        assert torch.equal(a[k], torch.ones_like(a[k])), k
    for k in ("backbone.norm0.bias", "crf0.norm_crf.bias",
              "decoder.psp_modules.0.1.gn.bias", "crf3.crf_layer.blocks.1.attn.qk.bias",
              "disp_head1.conv1.bias", "decoder.bottleneck.bn.running_mean"):
        assert torch.equal(a[k], torch.zeros_like(a[k])), k
    model = weights.reference_model(TINY, 5, CPU)
    for k in computed:
        assert torch.equal(model.state_dict()[k], built[k])


def tiny_flops(c: dict, b: int, h: int, w: int) -> int:
    """Convolutions and matrix products of one tiny forward, by hand: Swin's
    qkv and proj run over the padded windows, its MLP over the tokens."""
    bb, dec = c["backbone"], c["decoder"]
    ws, n = bb["window_size"], bb["window_size"] ** 2
    grids = [(h // 4, w // 4)]
    for _ in range(3):
        grids.append(((grids[-1][0] + 1) // 2, (grids[-1][1] + 1) // 2))

    def block(dim, heads, grid, qkv_out):
        t = b * grid[0] * grid[1]
        tp = b * -(-grid[0] // ws) * ws * -(-grid[1] // ws) * ws
        attention = 2 * 2 * (tp // n) * heads * n * n * (dim // heads)
        return 2 * tp * dim * qkv_out + attention + 2 * tp * dim * dim + 2 * 2 * t * dim * 4 * dim

    total = 2 * b * grids[0][0] * grids[0][1] * bb["embed_dim"] * 3 * 16
    for i, depth in enumerate(bb["depths"]):
        dim = bb["embed_dim"] * 2 ** i
        total += depth * block(dim, bb["num_heads"][i], grids[i], 3 * dim)
        if i < 3:
            nh, nw = grids[i + 1]
            total += 2 * b * nh * nw * 4 * dim * 2 * dim
    c3 = bb["embed_dim"] * 8
    ch, (h3, w3) = dec["channels"], grids[3]
    total += sum(2 * b * s * s * c3 * ch for s in dec["pool_scales"])
    total += 2 * b * h3 * w3 * (c3 + 4 * ch) * ch * 9
    for i in range(4):
        dim, (gh, gw) = dec["crf_dims"][i], grids[i]
        c_in = bb["embed_dim"] * 2 ** i  # proj_x only where the widths differ, proj_v always
        total += 2 * b * gh * gw * 9 * dim * ((c_in if c_in != dim else 0) + dec["v_dims"][i])
        total += dec["crf_depth"] * block(dim, dec["crf_heads"][i], grids[i], 2 * dim)
    return total + 2 * b * grids[0][0] * grids[0][1] * dec["crf_dims"][0] * 9


def test_forward_flops_by_hand():
    assert flops.forward_flops(TINY, 2, 64, 96) == tiny_flops(TINY, 2, 64, 96)
    assert flops.forward_flops(CONFIG, 1, 480, 640) == tiny_flops(CONFIG, 1, 480, 640)
    assert flops.forward_flops(CONFIG, 1, 480, 640) / 1e9 == pytest.approx(569.10, abs=5e-3)


def test_control_reaches_linear_layers():
    model = weights.reference_model(TINY, 7, CPU).eval()
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        exact = model(x, None)
        set_quant(model, fp8_round)
        assert model.backbone.layers[2].blocks[1].attn.qkv.quant is fp8_round
        assert model.crf0.crf_layer.blocks[0].mlp.fc2.quant is fp8_round
        assert model.decoder.bottleneck.conv.quant is fp8_round
        rounded = model(x, None)
    assert (rounded - exact).abs().max() > 1e-3


def test_window_attention_calls_at_published_size():
    calls = newcrfs.window_attn_calls(CONFIG, 8, 480, 640)
    assert len(calls) == 32
    swin, crf = calls[:24], calls[24:]
    assert sorted({(w, h) for w, h, *_ in swin}) == [(72, 48), (240, 24), (864, 12), (3312, 6)]
    assert [(w, h) for w, h, *_ in crf[::2]] == [(72, 32), (240, 16), (864, 8), (3312, 4)]
    assert [s for *_, s, _, _ in calls] == [False, True] * 16
    assert all(n == 49 and d == 32 for *_, n, d in calls)
    assert sum(1 for w, h, *_ in swin if (w, h) == (240, 24)) == 18
    ops, nbytes = newcrfs.window_attn_work(CONFIG, 8, 480, 640, 2)[1]  # stage 1, shifted
    assert ops == 4 * 3312 * 6 * 49 * 49 * 32
    assert nbytes == 2 * 4 * 3312 * 6 * 49 * 32 + 4 * 169 * 6 + 8 * 49 * 49 + 4 * 414 * 49 * 49


def test_kernel_readers():
    ms = 1_000_000
    per = [("kernel", f"window_attn_kernel_{i}", i * ms, i * ms + ms // 2) for i in range(64)]
    events = [("user_annotation", WINDOW, 0, 100 * ms), ("kernel", "gemm", 0, 70 * ms), *per]
    config = dict(CONFIG)
    run_ = SimpleNamespace(
        timeline=Timeline(events), counts={"images": 16, "forwards": 2}, config=config,
        traffic={"batch": 8}, counters={"window_attn_launches": 64},
        peaks=flops.peak("NVIDIA H100 80GB HBM3"), window_s=0.1)
    roofline = spec.reader("window_attn.roofline_pct")
    bound = sum(max(o / 989e12, b / 3.35e12)
                for o, b in newcrfs.window_attn_work(config, 8, 480, 640, 2))
    assert roofline(run_) == pytest.approx(100 * bound * 2 / (64 * 0.5e-3))
    assert spec.reader("window_attn.kernel_ms_per_img")(run_) == pytest.approx(64 * 0.5 / 16)
    run_.counters = {"window_attn_launches": 63}  # the trace lost none; the counter differs
    assert roofline(run_) is None
    run_.counters, run_.counts = {"window_attn_launches": 64}, {"images": 24, "forwards": 3}
    assert roofline(run_) is None  # 64 kernels are not 3 forwards' 96


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.models.newcrfs, benchmark.reference.newcrfs\n"
            "from benchmark import spec\n"
            "assert spec.model(spec.config('newcrfs-nyu-swinl07')) is benchmark.models.newcrfs\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = out.stdout.strip().splitlines()[-1]
    assert "bts_tpu_torch" not in tops and "bts_tpu" not in tops and "jax" not in tops
