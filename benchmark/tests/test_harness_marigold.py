"""Marigold v1-0 through the harness as files of its own
(``models/marigold.py``, ``reference/marigold.py``): a whole tiny CPU run of
its cell is correct, and not with a stale answer; the program is built from
the configuration's widths and fixes what upstream fixes; its seeded weights
keep the rules of ``weights.py``; its forward FLOPs equal a hand count
(about 21.2 TFLOP an image at 480x640, processed at 576x768); the float8
control reaches every linear layer and convolution; the U-Net's 32
attentions a call and their work at the published size; the denoiser's
attention reader on a synthetic trace; its reference and model file load
nothing of the program."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import flops, run, spec, weights
from benchmark.models import marigold
from benchmark.reference.lowp import fp8_round, set_quant
from benchmark.tests.tiny import shrink, tiny_config
from benchmark.trace import WINDOW, Timeline

CPU = torch.device("cpu")
CELL = "nyu-marigold-serve-b8"
CONFIG = spec.config("marigold-nyu-v1-0")
TINY = tiny_config(CONFIG)
SEED = 2**31 + 2605
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
    does (heads of 64, 32 groups, the U-Net's norm eps, 77 text tokens, the
    latent scale, the scheduler's constants), are the configuration's."""
    from bts_tpu_torch.models import marigold as program

    u, v, s = config["unet"], config["vae"], config["scheduler"]
    assert [c // h for c, h in zip(u["block_out_channels"], u["attention_head_dim"])] == [
        program.HEAD_DIM] * len(u["block_out_channels"])
    assert u["norm_num_groups"] == v["norm_num_groups"] == program.GROUPS
    assert u["norm_eps"] == program.UNET_EPS and v["scaling_factor"] == program.LATENT_SCALE
    assert (u["in_channels"], u["out_channels"]) == (2 * v["latent_channels"],
                                                     v["latent_channels"])
    assert u["flip_sin_to_cos"] and u["freq_shift"] == 0 and u["use_linear_projection"]
    assert (s["num_train_timesteps"], s["beta_start"], s["beta_end"], s["steps_offset"]) == (
        program.TRAIN_STEPS, program.BETA_START, program.BETA_END, program.STEPS_OFFSET)
    assert (s["beta_schedule"], s["timestep_spacing"], s["set_alpha_to_one"],
            s["prediction_type"]) == ("scaled_linear", "leading", False, "v_prediction")
    assert v["layers_per_block"] == u["layers_per_block"]
    for h, w in ((480, 640), (16, 24), (352, 1216)):
        assert marigold.model_input(config, h, w) == program.processing_size(
            h, w, config["processing_res"])
    if config is CONFIG:
        widths = marigold.port_widths(config)
        assert (widths.pop("max_depth"), widths.pop("min_depth")) == (10.0, 1e-3)
        assert widths == program.VERSIONS[config["encoder"]]
        with torch.device("meta"):
            model = marigold.reference(config)
        assert sum(p.numel() for p in model.parameters()) == config["parameters"]


def test_seeded_weights_follow_the_rules():
    a = weights.seeded_state_dict(TINY, 5, CPU)
    assert list(a) == list(marigold.reference(TINY).state_dict())
    embed = a["empty_text_embed"]
    assert abs(embed.std().item() - 0.02) < 0.003 and abs(embed.mean().item()) < 0.003
    for k in ("unet.down_blocks.0.resnets.0.norm1.weight", "vae.encoder.conv_norm_out.weight",
              "unet.mid_block.attentions.0.transformer_blocks.0.norm2.weight"):
        assert torch.equal(a[k], torch.ones_like(a[k])), k
    for k in ("unet.conv_in.bias", "vae.decoder.mid_block.attentions.0.to_q.bias",
              "unet.up_blocks.1.attentions.2.transformer_blocks.0.ff.net.0.proj.bias"):
        assert torch.equal(a[k], torch.zeros_like(a[k])), k
    port = marigold.port_model(TINY, a, CPU)
    assert torch.equal(port.state_dict()["empty_text_embed"], embed)


def hand_flops(c: dict, b: int, h: int, w: int) -> int:
    """Convolutions and matrix products of one forward, by hand: the VAE's
    encoder, ``denoise_steps`` U-Net calls and the VAE's decoder, at the
    processed frame that ``model_input`` gives."""
    u, v = c["unet"], c["vae"]
    ph, pw = marigold.model_input(c, h, w)

    def conv(cin, cout, k, hh, ww):
        return 2 * b * hh * ww * cout * cin * k * k

    def resnet(cin, cout, hh, ww, temb=0):
        n = conv(cin, cout, 3, hh, ww) + conv(cout, cout, 3, hh, ww)
        n += conv(cin, cout, 1, hh, ww) if cin != cout else 0
        return n + 2 * b * temb * cout

    def attention(ch, n_q, n_k, k_in):
        return 2 * b * (n_q * ch * ch * 2 + n_k * k_in * ch * 2) + 2 * 2 * b * n_q * n_k * ch

    def transformer(ch, hh, ww):
        n = hh * ww
        linears = 2 * b * n * ch * ch * 2 + 2 * b * n * (ch * 8 * ch + 4 * ch * ch)
        return (linears + attention(ch, n, n, ch)
                + attention(ch, n, 77, u["cross_attention_dim"]))

    def vae_mid(ch, hh, ww):
        return 2 * resnet(ch, ch, hh, ww) + attention(ch, hh * ww, hh * ww, ch)

    vc, layers = v["block_out_channels"], v["layers_per_block"]
    total = conv(3, vc[0], 3, ph, pw)
    hh, ww, prev = ph, pw, vc[0]
    for i, ch in enumerate(vc):
        total += resnet(prev, ch, hh, ww) + (layers - 1) * resnet(ch, ch, hh, ww)
        prev = ch
        if i < len(vc) - 1:
            hh, ww = hh // 2, ww // 2
            total += conv(ch, ch, 3, hh, ww)
    lh, lw, lat = hh, ww, v["latent_channels"]
    total += vae_mid(vc[-1], lh, lw) + conv(vc[-1], 2 * lat, 3, lh, lw)
    total += conv(2 * lat, 2 * lat, 1, lh, lw) + conv(lat, lat, 1, lh, lw)
    total += conv(lat, vc[-1], 3, lh, lw) + vae_mid(vc[-1], lh, lw)
    hh, ww, prev = lh, lw, vc[-1]
    for i, ch in enumerate(reversed(vc)):
        total += resnet(prev, ch, hh, ww) + layers * resnet(ch, ch, hh, ww)
        prev = ch
        if i < len(vc) - 1:
            hh, ww = 2 * hh, 2 * ww
            total += conv(ch, ch, 3, hh, ww)
    total += conv(vc[0], 3, 3, ph, pw)

    uc, te = u["block_out_channels"], 4 * u["block_out_channels"][0]
    last = len(uc) - 1
    call = 2 * b * (uc[0] * te + te * te) + conv(u["in_channels"], uc[0], 3, lh, lw)
    skips, hh, ww, prev = [uc[0]], lh, lw, uc[0]
    for i, ch in enumerate(uc):
        for _ in range(layers):
            call += resnet(prev, ch, hh, ww, te) + (transformer(ch, hh, ww) if i < last else 0)
            skips.append(ch)
            prev = ch
        if i < last:
            hh, ww = hh // 2, ww // 2
            call += conv(ch, ch, 3, hh, ww)
            skips.append(ch)
    call += 2 * resnet(uc[-1], uc[-1], hh, ww, te) + transformer(uc[-1], hh, ww)
    for i, ch in enumerate(reversed(uc)):
        for _ in range(layers + 1):
            call += resnet(prev + skips.pop(), ch, hh, ww, te)
            call += transformer(ch, hh, ww) if i > 0 else 0
            prev = ch
        if i < last:
            hh, ww = 2 * hh, 2 * ww
            call += conv(ch, ch, 3, hh, ww)
    call += conv(uc[0], u["out_channels"], 3, hh, ww)
    assert not skips and (hh, ww) == (lh, lw)
    return total + c["denoise_steps"] * call


def test_forward_flops_by_hand():
    assert flops.forward_flops(TINY, 2, 16, 24) == hand_flops(TINY, 2, 16, 24)
    assert flops.forward_flops(CONFIG, 1, 480, 640) == hand_flops(CONFIG, 1, 480, 640)
    assert flops.forward_flops(CONFIG, 1, 480, 640) / 1e9 == pytest.approx(21174.46, rel=1e-5)


def test_control_reaches_every_layer():
    model = weights.reference_model(TINY, 7, CPU).eval()
    x = torch.rand(2, 3, 16, 24, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        exact = model(x, None)
        set_quant(model, fp8_round)
        layers = [m for m in model.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
        with torch.device("meta"):
            plain = marigold.reference(TINY)
        assert len(layers) == sum(isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))
                                  for m in plain.modules()) > 100
        assert all(m.quant is fp8_round for m in layers)
        rounded = model(x, None)
    assert not torch.equal(rounded, exact)


def test_unet_attn_calls_at_published_size():
    calls = marigold.unet_attn_calls(CONFIG, 8, 480, 640)
    assert len(calls) == 32
    levels = [(5, 6912), (10, 1728), (20, 432)]
    want = []
    for heads, n in levels:
        want += [(8, heads, n, n, 64, 8), (8, heads, n, 77, 64, 1)] * 2
    want += [(8, 20, 108, 108, 64, 8), (8, 20, 108, 77, 64, 1)]
    for heads, n in reversed(levels):
        want += [(8, heads, n, n, 64, 8), (8, heads, n, 77, 64, 1)] * 3
    assert calls == want
    ops, nbytes = marigold.unet_attn_work(CONFIG, 8, 480, 640, 2)[0]
    assert ops == 4 * 8 * 5 * 6912 ** 2 * 64 and nbytes == 2 * 4 * 8 * 5 * 6912 * 64
    ops, nbytes = marigold.unet_attn_work(CONFIG, 8, 480, 640, 2)[1]
    assert ops == 4 * 8 * 5 * 6912 * 77 * 64 and nbytes == 2 * 5 * 64 * (2 * 8 * 6912 + 2 * 77)
    total = sum(o for o, _ in marigold.unet_attn_work(CONFIG, 1, 480, 640, 2))
    assert total / 1e12 == pytest.approx(0.3548, abs=1e-4)  # a U-Net call, an image


def test_unet_attn_reader():
    ms = 1_000_000
    per = [("kernel", f"global_attn_kernel_{i}", i * ms, i * ms + ms // 2) for i in range(64)]
    events = [("user_annotation", WINDOW, 0, 100 * ms), ("kernel", "gemm", 0, 70 * ms), *per]
    run_ = SimpleNamespace(
        timeline=Timeline(events), counts={"images": 8, "forwards": 1}, config=dict(CONFIG),
        traffic={"batch": 8}, counters={"unet_attn_launches": 64, "unet_calls": 2},
        peaks=flops.peak("NVIDIA H100 80GB HBM3"), window_s=0.1)
    roofline = spec.reader("unet_attn.roofline_pct")
    bound = sum(max(o / 989e12, b / 3.35e12)
                for o, b in marigold.unet_attn_work(CONFIG, 8, 480, 640, 2))
    assert roofline(run_) == pytest.approx(100 * bound * 2 / (64 * 0.5e-3))
    assert spec.reader("global_attn.kernel_ms_per_img")(run_) == pytest.approx(64 * 0.5 / 8)
    run_.counters = {"unet_attn_launches": 63, "unet_calls": 2}  # the counter differs
    assert roofline(run_) is None
    run_.counters = {"unet_attn_launches": 64, "unet_calls": 3}  # 64 kernels are not 3 calls'
    assert roofline(run_) is None
    run_.counters = {}  # a program without the counters
    assert roofline(run_) is None
    assert spec.reader("global_attn.roofline_pct")(run_) is None


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.models.marigold, benchmark.reference.marigold\n"
            "from benchmark import spec\n"
            "assert spec.model(spec.config('marigold-nyu-v1-0')) is benchmark.models.marigold\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = out.stdout.strip().splitlines()[-1]
    assert "bts_tpu_torch" not in tops and "bts_tpu" not in tops and "jax" not in tops


def test_parent_without_the_model_fails_at_once(monkeypatch):
    """A program without ``models/marigold.py`` (the checkout before it)
    raises in ``port_config``, before any weight is made."""
    import builtins

    real = builtins.__import__

    def without(name, *args, **kwargs):
        if name == "bts_tpu_torch.models" and args and args[2] and "marigold" in args[2]:
            raise ImportError("cannot import name 'marigold'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", without)
    with pytest.raises(ImportError):
        marigold.port_config(CONFIG, SEED)
