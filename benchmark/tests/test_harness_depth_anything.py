"""Depth Anything V2 through the harness as files of its own
(``models/depth_anything.py``, ``reference/depth_anything.py``): a whole
tiny CPU run of its cell is correct, and not with a stale answer; its
seeded weights keep the rules of ``weights.py``, LayerScale at one; its
forward FLOPs equal a hand count (6,077.1 GFLOP an image at 352x1216); the
float8 control reaches every linear layer, convolution and transposed
convolution; the global attention's calls and work at the published size;
the kernel metrics' readers on a synthetic trace; its reference and model
file load nothing of the program."""

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
from benchmark.models import depth_anything
from benchmark.reference.lowp import fp8_round, set_quant
from benchmark.tests.tiny import shrink, tiny_config
from benchmark.trace import WINDOW, Timeline

CPU = torch.device("cpu")
CELL = "kitti-dav2l-serve-b8"
CONFIG = spec.config("dav2-kitti-vitl-metric")
TINY = tiny_config(CONFIG)
SEED = 2**31 + 2404
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
    does (patch 14, MLP ratio 4, offset 0.1, eps 1e-6, the head's 32), are
    the configuration's."""
    from bts_tpu_torch.models import depth_anything as program
    from bts_tpu_torch.models.encoders import vit

    v, d = config["vit"], config["dpt"]
    assert v["patch_size"] == vit.PATCH and v["mlp_ratio"] == vit.MLP_RATIO
    assert v["interpolate_offset"] == vit.INTERPOLATE_OFFSET
    assert v["layer_norm_eps"] == vit.NORM_EPS and d["head_hidden"] == program.HEAD_HIDDEN
    for h, w in ((352, 1216), (480, 640), (48, 160)):
        assert depth_anything.model_input(config, h, w) == program.model_input(
            h, w, config["input_size"])
    if config is CONFIG:
        widths = depth_anything.port_widths(config)
        assert widths.pop("max_depth") == 80.0
        assert widths == program.VERSIONS[config["encoder"]]
        with torch.device("meta"):
            model = depth_anything.reference(config)
        assert sum(p.numel() for p in model.parameters()) == config["parameters"]


def test_seeded_weights_follow_the_rules():
    a, b = weights.seeded_state_dict(TINY, 5, CPU), weights.seeded_state_dict(TINY, 5, CPU)
    assert list(a) == list(depth_anything.reference(TINY).state_dict())
    for k in a:
        assert torch.equal(a[k], b[k])
    qkv = "pretrained.blocks.0.attn.qkv.weight"
    bound = math.sqrt(6.0 / (128 + 384))
    assert 0.9 * bound < a[qkv].abs().max() <= bound  # Linear: Xavier-uniform
    deconv = "depth_head.resize_layers.0.weight"  # ConvTranspose (in, out, 4, 4)
    bound = math.sqrt(6.0 / (32 * 16))
    assert 0.9 * bound < a[deconv].abs().max() <= bound
    flat = torch.cat([a[f"pretrained.{k}"].flatten() for k in ("cls_token", "pos_embed",
                                                                "mask_token")])
    assert abs(flat.std().item() - 0.02) < 0.003 and abs(flat.mean().item()) < 0.003
    scales = [k for k in a if ".ls" in k]
    assert len(scales) == 2 * 4 and all(k.endswith(".weight") for k in scales)
    for k in (*scales, "pretrained.norm.weight", "pretrained.blocks.2.norm2.weight"):
        assert torch.equal(a[k], torch.ones_like(a[k])), k  # LayerScale at init_values 1.0
    for k in ("pretrained.blocks.0.attn.qkv.bias", "depth_head.projects.3.bias",
              "depth_head.scratch.refinenet1.resConfUnit2.conv1.bias",
              "depth_head.scratch.output_conv2.2.bias"):
        assert torch.equal(a[k], torch.zeros_like(a[k])), k
    model = depth_anything.port_model(TINY, a, CPU)
    assert torch.equal(model.state_dict()["pretrained.blocks.1.ls2.gamma"],
                       a["pretrained.blocks.1.ls2.weight"])


def hand_flops(c: dict, b: int, h: int, w: int) -> int:
    """Convolutions, transposed convolutions and matrix products of one
    forward, by hand, at the model input that ``model_input`` gives."""
    v, d = c["vit"], c["dpt"]
    p, dim, feat, oc = v["patch_size"], v["embed_dim"], d["features"], d["out_channels"]
    mh, mw = depth_anything.model_input(c, h, w)
    gh, gw = mh // p, mw // p
    n = gh * gw + 1
    total = 2 * b * gh * gw * dim * 3 * p * p
    block = (2 * n * dim * 3 * dim + 2 * 2 * n * n * dim + 2 * n * dim * dim
             + 2 * 2 * n * dim * v["mlp_ratio"] * dim)
    total += b * v["depth"] * block
    s3 = gh * gw
    s4 = -(-gh // 2) * -(-gw // 2)
    s2, s1, s0 = 4 * s3, 16 * s3, 64 * s3
    total += sum(2 * b * s3 * dim * o for o in oc)  # projects
    total += 2 * b * s3 * oc[0] * oc[0] * 16 + 2 * b * s3 * oc[1] * oc[1] * 4
    total += 2 * b * s4 * oc[3] * oc[3] * 9
    total += sum(2 * b * s * o * feat * 9 for s, o in zip((s1, s2, s3, s4), oc))  # layer_rn
    conv3 = 2 * b * feat * feat * 9
    total += 2 * conv3 * s4 + 2 * b * feat * feat * s3  # refinenet4: one unit
    total += 4 * conv3 * (s3 + s2 + s1)  # refinenet3-1: two units each
    total += 2 * b * feat * feat * (s2 + s1 + s0)  # their out_convs
    total += 2 * b * feat * (feat // 2) * 9 * s0  # output_conv1
    total += 2 * b * (feat // 2) * d["head_hidden"] * 9 * mh * mw  # output_conv2: 3x3, 1x1
    total += 2 * b * d["head_hidden"] * mh * mw
    return total


def test_forward_flops_by_hand():
    assert flops.forward_flops(TINY, 2, 48, 160) == hand_flops(TINY, 2, 48, 160)
    assert flops.forward_flops(CONFIG, 1, 352, 1216) == hand_flops(CONFIG, 1, 352, 1216)
    assert flops.forward_flops(CONFIG, 1, 352, 1216) / 1e9 == pytest.approx(6077.1, rel=1e-3)
    assert flops.forward_flops(CONFIG, 1, 480, 640) / 1e9 == pytest.approx(1806.1, rel=1e-3)


def test_control_reaches_every_layer():
    model = weights.reference_model(TINY, 7, CPU).eval()
    x = torch.randn(2, 3, 48, 160, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        exact = model(x, None)
        set_quant(model, fp8_round)
        layers = [m for m in model.modules() if isinstance(
            m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        assert len(layers) == 4 * 4 + 1 + 4 + 3 + 4 + 4 * 5 + 1 + 2
        assert all(m.quant is fp8_round for m in layers)
        rounded = model(x, None)
    assert (rounded - exact).abs().max() > 1e-3


def test_global_attention_calls_at_published_size():
    calls = depth_anything.global_attn_calls(CONFIG, 8, 352, 1216)
    assert calls == [(8, 16, 4737, 64)] * 24
    ops, nbytes = depth_anything.global_attn_work(CONFIG, 8, 352, 1216, 2)[0]
    assert ops == 4 * 8 * 16 * 4737 ** 2 * 64 and ops / 1e9 == pytest.approx(735.29, abs=0.005)
    assert nbytes == 2 * 4 * 8 * 4737 * 1024


def test_kernel_readers():
    ms = 1_000_000
    per = [("kernel", f"global_attn_kernel_{i}", i * ms, i * ms + ms // 2) for i in range(48)]
    events = [("user_annotation", WINDOW, 0, 100 * ms), ("kernel", "gemm", 0, 70 * ms), *per]
    run_ = SimpleNamespace(
        timeline=Timeline(events), counts={"images": 16, "forwards": 2}, config=dict(CONFIG),
        traffic={"batch": 8}, counters={"global_attn_launches": 48},
        peaks=flops.peak("NVIDIA H100 80GB HBM3"), window_s=0.1)
    roofline = spec.reader("global_attn.roofline_pct")
    bound = sum(max(o / 989e12, b / 3.35e12)
                for o, b in depth_anything.global_attn_work(CONFIG, 8, 352, 1216, 2))
    assert roofline(run_) == pytest.approx(100 * bound * 2 / (48 * 0.5e-3))
    assert spec.reader("global_attn.kernel_ms_per_img")(run_) == pytest.approx(48 * 0.5 / 16)
    run_.counters = {"global_attn_launches": 47}  # the trace lost none; the counter differs
    assert roofline(run_) is None
    run_.counters, run_.counts = {"global_attn_launches": 48}, {"images": 24, "forwards": 3}
    assert roofline(run_) is None  # 48 kernels are not 3 forwards' 72
    run_.counters = {}  # a program without the kernel's counter
    assert roofline(run_) is None


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.models.depth_anything, benchmark.reference.depth_anything\n"
            "from benchmark import spec\n"
            "assert spec.model(spec.config('dav2-kitti-vitl-metric')) is "
            "benchmark.models.depth_anything\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = out.stdout.strip().splitlines()[-1]
    assert "bts_tpu_torch" not in tops and "bts_tpu" not in tops and "jax" not in tops
