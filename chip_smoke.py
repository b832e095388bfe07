#!/usr/bin/env python3
"""Smoke run of bts_tpu_torch on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure raises and the script exits nonzero:

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``bts_tpu_torch/csrc`` (one nvcc per
   source, all started together, then one link);
3. kernels against plain (TF32 off), each timed by CUDA events (device time
   per call) beside its plain PyTorch version:
   - LPG at the three NYU 480x640 sites (batch 8) and ragged cases at r = 2,
     4 and 8, bit for bit: the bare map in f32, and the decoder's site
     (``/ max_depth`` and the cast fused) in f32 and bf16 against
     ``lpg_scaled_reference``; the site's unfused form (the bare kernel, then
     PyTorch's division and cast) is timed beside it;
   - the fused dense layer, taps and eo, in bf16 and f32, at the first and
     the last layer of each DenseNet161 block at 480x640, batch 8 and batch
     1, against the plain fused versions (the same rounding points): bf16
     rtol 2e-2, atol 2e-2 (one bf16 ulp of an output, about 2^-8 relative,
     may flip with the summation order), f32 rtol 1e-4, atol 1e-4 (the f32
     kernels run 3xTF32 products). The unfused cuDNN chain of the layer
     (what ``dense_impl='plain'`` runs: BN, ReLU, 1x1, BN, ReLU, 3x3 and the
     concat) is timed beside them;
   - DenseNet121's (Cmid, G) = (128, 32) instantiation of both forms, at
     the first and the last layer of each of its blocks, both dtypes, B=8
     and B=1, against the plain fused versions at the same tolerances;
4. the port on the card against the port on the CPU in f32, seeded
   weights, batch 1, all 5 outputs at rtol 1e-3, atol 1e-4 (cuDNN sums in
   another order), with ``dense_impl`` auto (taps kernel) and eo: exactly
   one launch of that kernel per dense layer, none of the other, and 3 LPG
   launches per forward; DenseNet161-BTS NYU at 96x128, DenseNet121-BTS NYU
   at 480x640, and DenseNet161-BTS KITTI at 352x1216 with focal scaling;
5. the serving path: ``bts_tpu_torch.cli.test.main`` over 8 synthetic NYU
   480x640 frames in bf16, with the kernels' launch counts reset just
   before; 8 uint16 pngs, and exactly 78 taps, 0 eo and 3 LPG launches per
   forward;
6. bf16 against f32 on one 4x480x640 batch (max abs diff < 0.15 m), for
   dense_impl auto and for eo (the eo path: its launch counts reset just
   before, 78 eo launches); then the forward's img/s in bf16 at batch 1 and
   8, in turns, with the dense layers plain, through the taps kernel and
   through the eo kernel, and with the plain LPG (xla); and in f32 (TF32
   off, as phase 3 set it) at batch 8 with the dense layers plain, auto and
   eo;
7. training:
   (a) the LPG backward kernel against ``lpg_backward_scaled`` at the three
       train sites of a 4x416x544 batch, with f32 and bf16 incoming
       gradients, and ragged cases at r = 2, 4 and 8 with a strided
       gradient (``LPG_BWD_TOL``: the sums run in another order), timed
       beside the plain version and its bound, per site and for the three,
       with a launch's floor (a one-element in-place add) beside them; the
       LPG forward timed at the same sites;
   (b) one f32 train step (TF32 off) of DenseNet161-BTS at full width on a
       2x416x544 batch, card against CPU: the loss at rtol 1e-4, every
       parameter and BN statistic at atol 1e-4; exactly 3 LPG forward and 3
       LPG backward launches and no fused dense launch;
   (c) the slice's main path: ``bts_tpu_torch.cli.train.main`` with
       ``configs/arguments_train_nyu.txt`` as it is (DenseNet161-BTS,
       416x544, batch 4, bf16, ``--device_augment``, host rotation, online
       eval with the eigen crop) over 24 synthetic NYU 480x640 frames for 6
       steps, its eval split the first 8 of them, evaluated every 3 steps at
       batch 4, the counts reset just before: finite logged losses, 3 LPG
       backward launches a step, a ``model-N-best_<metric>_<value>`` file
       for each of the nine metrics and no ``model-N``;
   (d) the train step's img/s in bf16 at batch 4 and 16 (or the largest of
       12 and 8 that fits) and in f32 at batch 4, after 3 warm-up steps;
8. eval:
   (a) ``make_batch_metrics`` on the card against the numpy protocol on the
       CPU (``METRICS_TOL``), NYU 480x640 with the eigen crop and KITTI
       352x1216 with the garg crop at batch 8, seeded predictions with inf,
       nan and out-of-range values and uint16 gt with holes; the gt meters
       on the card bit for bit;
   (b) phase 7(c)'s online evals: 78 taps and 3 LPG forward launches a
       forward and no backward; a fresh model on a best checkpoint gives
       the measures the loop logged at that step within rtol 1e-5 (a stale
       fold of the BN statistics or a wrong mode would not);
   (c) ``cli.eval`` over a run dir holding ``model-3`` and ``model-6``: each
       evaluated, the ledger written; a second call evaluates nothing.
       ``cli.test`` from a best checkpoint over the 8 eval frames, and
       ``cli.eval_with_pngs`` over its pngs: nine finite metrics over 8;
   (d) ``run_online_eval``'s img/s at 480x640, bf16, batch 8, with the
       device metrics on and off (host decoding included), and the eval
       loader's own img/s over the same frames;
9. the encoder zoo and the demos (each path's counts reset just before it
   and read just after; no fused dense launch on any of them):
   (a) ResNet-50/101, ResNeXt-50/101 and MobileNetV2-BTS at full width,
       seeded, f32 (TF32 off), NYU 480x640 batch 1 on the card against the
       CPU, all 5 outputs at rtol 1e-3, atol 1e-4, and ResNeXt-50 at KITTI
       352x1216: 3 LPG launches a forward; each family's bf16 img/s at
       batch 8;
   (b) ``cli.test`` with ResNet-50 from a reference trainer's save (DDP
       prefix, torchvision's ``fc``) over 8 NYU frames in bf16;
   (c) ``cli.train`` with ResNeXt-50 on the recipe (416x544, batch 4, bf16,
       ``--device_augment``) for 4 steps, ``model-2`` and ``model-4`` saved:
       3 LPG backward launches a step; one f32 train step of ResNet-50 and of
       MobileNetV2, card against CPU as in 7(b) but held to a float64 CPU
       step (the card no further from it than 2x the CPU's f32 step), with
       set_misc's frozen set (ResNet: stem and block BNs frozen,
       ``downsample.1`` trainable; MobileNetV2: nothing);
   (d) ``cli.avg_checkpoints`` over those two files (each tensor the
       float64 mean cast back), then ``cli.test`` from the average;
   (e) ``cli.sequence`` over 4 frames of 470x620 and ``cli.live3d
       --image_dir`` over 2 frames on the average, then the live3d
       ``depth_fn``'s batch-1 ms a frame at 480x640 (DenseNet161 in f32 and
       bf16, MobileNetV2 in f32, ResNeXt-50 in bf16);
10. the TF graph (``--model_flavor tf``: the reference's TF zoo graph,
    encoder BN eps 1.1e-5 folded into the taps kernels, the align-corners
    guidance) and the native CPU LPG (each path's counts reset just before
    it and read just after):
   (a) a seeded TF-graph DenseNet161-BTS at full width (biases and BN
       statistics drawn), NYU 480x640 batch 1, f32 with TF32 off, on the card
       (``dense_impl`` and ``lpg_impl`` auto) against the CPU (plain
       versions), all 5 outputs at rtol 1e-3, atol 1e-4: 78 f32 taps and 3
       LPG launches; then bf16 on the card: 78 bf16 taps and 3 LPG, within
       0.15 m of f32;
   (b) the same at KITTI 352x1216, batch 1 (the ``bts_eigen_v2`` geometry);
   (c) ``cli.test`` from a TF-graph ``.pth`` the phase saves, with
       ``--model_flavor auto --normalization auto``: it prints the resolved
       ``tf`` and ``caffe``, 8 uint16 pngs, 78 taps and 3 LPG a forward. A
       TF checkpoint prefix needs tensorflow, which the card's host has not:
       the CPU tests hold that path (tests/test_torch_tf_flavor.py);
   (d) one f32 TF-graph train step, card against CPU as 7(b) (every BN
       frozen); then ``cli.train`` for 4 steps at full width on
       ``configs/arguments_train_nyu.txt`` with ``--model_flavor tf`` (online
       eval off, ``model-4`` saved): finite losses, 3 LPG backward a step,
       and every BN statistic in ``model-4`` as seeded (mean 0, variance 1,
       no batch counted);
   (e) bf16 img/s at batch 8, 480x640, of the TF graph beside the PT graph,
       in turns (PT, TF, TF, PT);
   (f) the native CPU LPG (``csrc/lpg_cpu.cc``, ``--lpg_impl ffi``) built
       with g++ on the card's host: forward and gradient against the plain
       versions at r = 8, 4 and 2 at tests/test_lpg_ffi.py's shapes and
       tolerances (forward rtol 1e-5, atol 1e-6; gradient rtol 1e-4, atol
       1e-5), and at the three NYU sites at batch 1 with TF-graph planes
       (theta at most pi/6; forward at the same tolerance, gradient at
       ``LPG_BWD_TOL`` of its terms' magnitude, the sums run in another
       order); both timed on the host against the plain versions, the CPU
       named from /proc/cpuinfo; ``impl="ffi"`` on a CUDA tensor raises.
Each phase's seconds are printed as it ends, and as JSON after phase 10.

The line before the last is the kernels' JSON record (``launches`` from the
serving path of phase 5 for LPG and bf16 taps, from phase 4's f32 forwards
for f32 taps and f32 eo, from the bf16 eo forward of phase 6 for bf16 eo,
from phase 7's ``cli.train`` for the LPG backward, with its per-site times
and the launch floor; both LPG records carry phase 9's counts by path, and
they and the taps records phase 10's under ``tf_launches``;
``ms``/``plain_ms`` summed over the phase-3 shapes or sites at B=8, in the
record's dtype, the dense kernels' ``b1`` at B=1; eo's ``bound_ms`` counts
its own work, ``layer_bound_ms`` the taps form's); the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
from PIL import Image

NYU_SITES = [(8, 60, 80), (4, 120, 160), (2, 240, 320)]  # (r, grid h, grid w)
LPG_SOURCE = "bts_tpu_torch/csrc/lpg.cu"
LPG_REPLACES = "bts_tpu/ops/lpg_pallas.py:38"
MAX_DEPTH = 10.0  # NYU
DENSE_SOURCE = {("taps", "bfloat16"): "bts_tpu_torch/csrc/fused_dense_taps_sm90.cu",
                ("taps", "float32"): "bts_tpu_torch/csrc/fused_dense_taps_f32_sm90.cu",
                ("eo", "bfloat16"): "bts_tpu_torch/csrc/fused_dense_taps_sm90.cu",
                ("eo", "float32"): "bts_tpu_torch/csrc/fused_dense_taps_f32_sm90.cu"}
DENSE_REPLACES = {"taps": "docs/archive/fused_dense.py:167", "eo": "docs/archive/fused_dense.py:216"}
DENSE_LAYERS = 78  # DenseNet161: 6 + 12 + 36 + 24
# The train step's LPG sites: the NYU recipe's 416x544 crop at batch 4.
TRAIN_SITES = [(8, 52, 68), (4, 104, 136), (2, 208, 272)]  # (r, grid h, grid w)
TRAIN_BATCH = 4
LPG_BWD_REPLACES = "bts_tpu/ops/lpg.py:88"
# The backward's sums run in another order than PyTorch's reductions: each
# component is held to rtol 1e-5 of the sum of its terms' magnitudes, plus
# atol 1e-6. Two f32 sums of at most 64 terms each err by at most about
# 64 * 2^-24 = 3.8e-6 of that sum; the result itself may cancel to near 0.
LPG_BWD_TOL = dict(rtol=1e-5, atol=1e-6)
# Phase 7(c)'s online eval: its frames and the eval every EVAL_FREQ steps at
# EVAL_BATCH (so one eval is EVAL_FRAMES / EVAL_BATCH forwards).
EVAL_FRAMES, EVAL_BATCH, EVAL_FREQ = 8, 4, 3
# Device metrics against the numpy protocol: test_eval_apps.py's bar between
# f32 device sums and the f64 host path.
METRICS_TOL = dict(rtol=1e-4, atol=1e-5)
DENSE_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-4, atol=1e-4)}
# One H100 SXM's published peaks (dense): bf16 tensor cores; f32-accurate
# products as 3xTF32 on the tensor cores, three TF32 products (494.7 TFLOP/s)
# for each f32 one (with FMAs outside the tensor cores f32 peaks at 67
# TFLOP/s); and HBM3. The bounds below divide this run's work by them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# Phase 9: the encoders beside DenseNet, and the frames of its demos.
ZOO_ENCODERS = ["resnet50_bts", "resnet101_bts", "resnext50_bts", "resnext101_bts",
                "mobilenetv2_bts"]
ZOO_TRAIN_STEPS = 4
SEQUENCE_FRAMES, SEQUENCE_HW = 4, (470, 620)  # not multiples of 32
LIVE3D_FRAMES = 2
# Phase 10: cli.train's steps on the TF graph, and the native CPU LPG's
# tolerances (tests/test_lpg_ffi.py's).
TF_TRAIN_STEPS = 4
FFI_FWD_TOL = dict(rtol=1e-5, atol=1e-6)
FFI_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


PHASE_SECONDS = {}  # phase -> its seconds, host clock
_CURRENT = []  # [(name, start)] of the phase under way


def phase(msg=None):
    """Start phase ``msg`` (None: end the last), printing the seconds of
    the one before."""
    now = time.perf_counter()
    if _CURRENT:
        name, start = _CURRENT.pop()
        PHASE_SECONDS[name] = now - start
        print(f"-- phase {name}: {now - start:.1f} s", flush=True)
    if msg is not None:
        _CURRENT.append((msg.split()[0], now))
        print(f"== {msg}", flush=True)


def cuda_median_ms(fn, samples=50, reps=10, warmup=5):
    """Median over samples of fn's device time per call; each sample is one
    CUDA event pair around reps back-to-back calls.

    A spin kernel before each sample holds the stream while the host
    enqueues it, so the events time the device's work and not the host's
    launch overhead.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(samples):
        torch.cuda._sleep(4_000_000)  # about 2 ms at H100 clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / reps for s, e in events)


def bound_ms(flops, nbytes, dtype_name):
    """(ms, 'operations' or 'bytes'): the least time the card could take,
    the larger of flops at the dtype's peak and bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def lpg_bound(b, h, w, r, out_esize=4):
    """LPG at one site: the (B,h,w,4) f32 planes read once, the (B,h*r,w*r)
    map written once in the output dtype (``out_esize`` bytes); per output 2
    mul, 2 add, 1 div and the scale."""
    outputs = b * h * r * w * r
    return bound_ms(6 * outputs, 16 * b * h * w + out_esize * outputs, "float32")


def dense_work(b, h, w, c, cmid=192, g=48, esize=2, eo=False):
    """(flops, bytes) of one dense layer: the 1x1 and the 3x3 products; x
    read once, out written once, and the folded weights read once. The taps
    form's 3x3 is 9*Cmid*G MACs a pixel; the eo form multiplies the whole
    packed (3, 4*Cmid, 2G) kernel, zero blocks included: 12*Cmid*G MACs a
    pixel, and reads its 24*Cmid*G weights."""
    flops = 2 * b * h * w * (c * cmid + (12 if eo else 9) * cmid * g)
    w2 = (24 if eo else 9) * cmid * g
    nbytes = esize * (b * h * w * (c + g) + c * cmid + w2 + 2 * (c + cmid))
    return flops, nbytes


def check_lpg(torch, lpg_cuda, lpg):
    """Phase 3, LPG. Each case once against its plain version, bit for bit:
    the bare map (f32) and the decoder's site (``/ MAX_DEPTH``, cast) in f32
    and bf16; then, at the NYU sites, each timed. Returns {key: [max abs err,
    kernel ms, plain ms, bound ms, unfused ms]} summed over the three NYU
    sites at batch 8 (one forward's worth), for keys "bare" (f32) and the
    site's output dtype names; "unfused" is the bare kernel followed by
    PyTorch's division and cast, the site as the decoder ran it before."""
    gen = torch.Generator().manual_seed(0)
    cases = [(r, 8, h, w) for r, h, w in NYU_SITES] + [(r, 3, 5, 7) for r in (8, 4, 2)]
    res = {}
    for i, (r, b, h, w) in enumerate(cases):
        logits = torch.randn(b, h, w, 3, generator=gen).cuda()
        pe = lpg.normalize_plane(lpg.decode_plane_eq(logits, MAX_DEPTH)).contiguous()
        runs = {"bare": (lambda: lpg_cuda.lpg_cuda(pe, r), lambda: lpg.lpg_reference(pe, r),
                         None, 4)}
        for dt in (torch.float32, torch.bfloat16):
            runs[str(dt).removeprefix("torch.")] = (
                lambda dt=dt: lpg_cuda.lpg_cuda(pe, r, MAX_DEPTH, dt),
                lambda dt=dt: lpg.lpg_scaled_reference(pe, r, MAX_DEPTH, dt),
                lambda dt=dt: (lpg_cuda.lpg_cuda(pe, r) / MAX_DEPTH).to(dt),
                dt.itemsize)
        for key, (kernel, plain, unfused, esize) in runs.items():
            before = lpg_cuda.LAUNCHES
            got = kernel()
            torch.cuda.synchronize()
            if lpg_cuda.LAUNCHES != before + 1:
                raise RuntimeError("lpg_cuda did not count its launch")
            want = plain()
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
            finite = torch.isfinite(want)
            err = (got.float() - want.float())[finite].abs().max().item()
            if i >= len(NYU_SITES):
                print(f"lpg {key} r={r} B={b} grid {h}x{w}: bit-equal to the plain version")
                continue
            k = cuda_median_ms(kernel)
            p = cuda_median_ms(plain)
            u = cuda_median_ms(unfused) if unfused else None
            bound = lpg_bound(b, h, w, r, esize)[0]
            print(f"lpg {key} r={r} B={b} grid {h}x{w} -> {h * r}x{w * r}: bit-equal, max_abs_err "
                  f"{err!r}, kernel {k!r} ms, plain {p!r} ms, unfused {u!r} ms (median of 50 "
                  f"samples of 10 calls); bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of it")
            acc = res.setdefault(key, [0.0, 0.0, 0.0, 0.0, 0.0 if unfused else None])
            res[key] = [max(acc[0], err), acc[1] + k, acc[2] + p, acc[3] + bound,
                        acc[4] + u if unfused else None]
    return res


# name -> (stem channels, growth G, layers per block); Cmid = 4 G.
DENSENETS = {"densenet161": (96, 48, (6, 12, 36, 24)), "densenet121": (64, 32, (6, 12, 24, 16))}


def densenet_layer_shapes(net, h=480, w=640):
    """(grid h, grid w, C) of the first and the last dense layer of each
    block of ``net`` at an h x w input."""
    c, g, blocks = DENSENETS[net]
    shapes = []
    for i, n in enumerate(blocks):
        s = 4 * 2**i
        shapes += [(h // s, w // s, c), (h // s, w // s, c + (n - 1) * g)]
        c = (c + n * g) // 2
    return shapes


def densenet161_layer_shapes(h=480, w=640):
    """(grid h, grid w, C) of the first and the last dense layer of each
    DenseNet161 block (growth 48) at an h x w input."""
    return densenet_layer_shapes("densenet161", h, w)


def seeded_dense_layer(torch, DenseLayer, c, gen, growth=48):
    """A dense layer on the card (DenseNet161's growth 48 by default): BN
    statistics drawn around their defaults, convs at the init's He scale,
    from ``gen``."""
    layer = DenseLayer(c, growth)
    with torch.no_grad():
        for bn in (layer.norm1, layer.norm2):
            n = bn.num_features
            bn.weight.copy_(torch.rand(n, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(n, generator=gen) * 0.1)
            bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
        for conv in (layer.conv1, layer.conv2):
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (2 / fan_in) ** 0.5)
    return layer.cuda().eval()


def check_dense_kernels(torch, fd, fdc, DenseLayer):
    """Phase 3, the fused dense layer: taps and eo, bf16 and f32, at B=8 and
    B=1, each shape against its plain version, then timed beside the plain
    version and the unfused cuDNN chain. Returns {(impl, dtype name, B):
    sums over the shapes} with keys max_abs_err (the largest), ms, plain_ms,
    cudnn_chain_ms, bound_ms (the form's own work), flops, bytes and, for eo,
    layer_bound_ms (the taps form's work: the same layer)."""
    gen = torch.Generator().manual_seed(3)
    launch = {"taps": fdc.fused_dense_cuda, "eo": fdc.fused_dense_eo_cuda}
    plain = {"taps": fd.fused_dense_reference, "eo": fd.fused_dense_eo_reference}
    res = {}

    def run(impl, name, args, kmajor, b, h, w, c):
        """One synchronised launch against the plain version, then both timed."""
        counts = fdc.TAPS_LAUNCHES, fdc.EO_LAUNCHES
        got = launch[impl](*args, kmajor=kmajor)
        torch.cuda.synchronize()
        added = fdc.TAPS_LAUNCHES - counts[0], fdc.EO_LAUNCHES - counts[1]
        if added != ((1, 0) if impl == "taps" else (0, 1)):
            raise RuntimeError(f"fused dense {impl}: launch counts moved by {added}")
        want = plain[impl](*args)
        torch.testing.assert_close(got, want, **DENSE_TOL[name])
        err = (got.float() - want.float()).abs().max().item()
        k = cuda_median_ms(lambda: launch[impl](*args, kmajor=kmajor), samples=20, reps=5)
        p = cuda_median_ms(lambda: plain[impl](*args), samples=20, reps=5)
        esize = 2 if name == "bfloat16" else 4
        flops, nbytes = dense_work(b, h, w, c, esize=esize, eo=impl == "eo")
        bound, by = bound_ms(flops, nbytes, name)
        rec = {"max_abs_err": err, "ms": k, "plain_ms": p, "bound_ms": bound, "flops": flops,
               "bytes": nbytes}
        layer = ""
        if impl == "eo":
            rec["layer_bound_ms"] = bound_ms(*dense_work(b, h, w, c, esize=esize), name)[0]
            layer = (f", layer bound {rec['layer_bound_ms'] * 1e3!r} us "
                     f"({rec['layer_bound_ms'] / k:.2%})")
        print(f"dense {impl} {name} B={b} {h}x{w} C={c}: max_abs_err {err!r}, "
              f"kernel {k!r} ms, plain {p!r} ms (median of 20 samples of 5 calls); "
              f"bound {bound * 1e3!r} us by {by}, {bound / k:.2%} of it{layer}, "
              f"{flops / k / 1e9!r} TFLOP/s")
        return rec

    def chain(layer, x, name, b, h, w, c):
        xn = x.permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16,
                                                    enabled=name == "bfloat16"):
            ch = cuda_median_ms(lambda: torch.cat([xn, layer(xn)], 1), samples=20, reps=5)
        flops = dense_work(b, h, w, c)[0]
        print(f"dense cuDNN chain {name} B={b} {h}x{w} C={c}: {ch!r} ms, "
              f"{flops / ch / 1e9!r} TFLOP/s")
        return ch

    for h, w, c in densenet161_layer_shapes():
        layer = seeded_dense_layer(torch, DenseLayer, c, gen)
        x32 = torch.randn(8, h, w, c, generator=gen).cuda()
        for b in (8, 1):
            for dt in (torch.bfloat16, torch.float32):
                name = str(dt).removeprefix("torch.")
                x = x32[:b].to(dt)
                for impl in ("taps", "eo"):
                    s1, b1, w1, s2, b2, w2, w2q, kmajor = layer.folded(dt, impl == "eo")
                    args = ((x,) if impl == "taps" else (x[:, :, 0::2], x[:, :, 1::2])) + (
                        s1, b1, w1, s2, b2, w2 if impl == "taps" else w2q)
                    rec = run(impl, name, args, kmajor, b, h, w, c)
                    acc = res.setdefault((impl, name, b), {"cudnn_chain_ms": 0.0})
                    for key, v in rec.items():
                        acc[key] = max(acc.get(key, v), v) if key == "max_abs_err" else (
                            acc.get(key, 0) + v)
                ch = chain(layer, x, name, b, h, w, c)
                for impl in ("taps", "eo"):
                    res[impl, name, b]["cudnn_chain_ms"] += ch
    return res


def check_densenet121_kernels(torch, fd, fdc, DenseLayer):
    """Phase 3, DenseNet121's (Cmid, G) = (128, 32) instantiation of both
    forms: the first and the last layer of each block at 480x640, taps and
    eo, bf16 and f32, B=8 and B=1, each against its plain version at the
    DenseNet161 tolerances; the kernel timed. Returns {(impl, dtype name,
    B): {"max_abs_err", "ms"}} over the 8 shapes."""
    gen = torch.Generator().manual_seed(4)
    launch = {"taps": fdc.fused_dense_cuda, "eo": fdc.fused_dense_eo_cuda}
    plain = {"taps": fd.fused_dense_reference, "eo": fd.fused_dense_eo_reference}
    res = {}
    for h, w, c in densenet_layer_shapes("densenet121"):
        layer = seeded_dense_layer(torch, DenseLayer, c, gen, growth=32)
        x32 = torch.randn(8, h, w, c, generator=gen).cuda()
        for b in (8, 1):
            for dt in (torch.bfloat16, torch.float32):
                name = str(dt).removeprefix("torch.")
                x = x32[:b].to(dt)
                for impl in ("taps", "eo"):
                    s1, b1, w1, s2, b2, w2, w2q, kmajor = layer.folded(dt, impl == "eo")
                    args = ((x,) if impl == "taps" else (x[:, :, 0::2], x[:, :, 1::2])) + (
                        s1, b1, w1, s2, b2, w2 if impl == "taps" else w2q)
                    got = launch[impl](*args, kmajor=kmajor)
                    torch.cuda.synchronize()
                    want = plain[impl](*args)
                    torch.testing.assert_close(got, want, **DENSE_TOL[name])
                    err = (got.float() - want.float()).abs().max().item()
                    k = cuda_median_ms(lambda: launch[impl](*args, kmajor=kmajor), samples=10,
                                       reps=5)
                    print(f"densenet121 dense {impl} {name} B={b} {h}x{w} C={c} (Cmid 128, G 32): "
                          f"max_abs_err {err!r}, kernel {k!r} ms")
                    acc = res.setdefault((impl, name, b), {"max_abs_err": 0.0, "ms": 0.0})
                    acc["max_abs_err"] = max(acc["max_abs_err"], err)
                    acc["ms"] += k
    return res


def lpg_backward_bound(b, h, w, r, grad_esize):
    """LPG backward at one site: the (B, h*r, w*r) gradient read once in its
    dtype, the (B,h,w,4) f32 planes read and the (B,h,w,4) f32 result written;
    per gradient element 14 f32 operations (scale, den, 1/den, the terms,
    the four sums)."""
    elems = b * h * r * w * r
    return bound_ms(14 * elems, grad_esize * elems + 2 * 16 * b * h * w, "float32")


def lpg_backward_magnitudes(torch, lpg, pe, grad, r, max_depth):
    """Per cell and component, the sum of the magnitudes of the terms that
    ``lpg_backward_scaled`` adds (its error scale)."""
    b, h, w, _ = pe.shape
    g = grad.float() / max_depth
    den, n4, u = lpg._den(pe, r)
    inv = 1.0 / den
    gt = g.reshape(b, h, r, w, r)
    c = (gt * n4 * inv * inv).abs()
    return torch.stack([(c * u.abs()).sum((2, 4)), (c * u.abs()[:, None, None]).sum((2, 4)),
                        c.sum((2, 4)), (gt * inv).abs().sum((2, 4))], dim=-1)


def launch_floor_ms(torch):
    """A launch's floor, timed as the kernels are (``cuda_median_ms``): a
    one-element in-place add on the card."""
    one = torch.zeros(1, device="cuda")
    return cuda_median_ms(lambda: one.add_(1))


def check_lpg_train(torch, lpg_cuda, lpg):
    """Phase 7a: the LPG backward kernel against ``lpg_backward_scaled`` at
    the three train sites (batch 4) with f32 and bf16 incoming gradients, and
    ragged cases at r = 2, 4 and 8 with a strided gradient (a channel of a
    wider map); then each train site timed (backward kernel and plain, and
    the forward kernel with bf16 out and its plain version). Returns
    ({grad dtype name: {"max_abs_err", "ms", "plain_ms", "bound_ms", "sites":
    [{"r", "ms", "bound_ms", "after_add_ms"}, ...]}}, forward [ms, plain ms,
    bound ms]), summed over the three sites; ``after_add_ms`` times a
    one-element add and then the kernel, as autograd launches it after
    another kernel."""
    gen = torch.Generator().manual_seed(6)
    one = torch.zeros(1, device="cuda")
    cases = [(r, TRAIN_BATCH, h, w, False) for r, h, w in TRAIN_SITES]
    cases += [(r, 3, 5, 7, True) for r in (8, 4, 2)]
    bwd, fwd = {}, [0.0, 0.0, 0.0]
    for i, (r, b, h, w, strided) in enumerate(cases):
        logits = torch.randn(b, h, w, 3, generator=gen).cuda()
        pe = lpg.normalize_plane(lpg.decode_plane_eq(logits, MAX_DEPTH)).contiguous()
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).removeprefix("torch.")
            if strided:
                grad = torch.randn(b, 3, h * r, w * r, generator=gen).to(dt).cuda()[:, 1]
            else:
                grad = torch.randn(b, h * r, w * r, generator=gen).to(dt).cuda()
            before = lpg_cuda.BWD_LAUNCHES
            got = lpg_cuda.lpg_backward_cuda(pe, grad, r, MAX_DEPTH)
            torch.cuda.synchronize()
            if lpg_cuda.BWD_LAUNCHES != before + 1:
                raise RuntimeError("lpg_backward_cuda did not count its launch")
            want = lpg.lpg_backward_scaled(pe, grad, r, MAX_DEPTH)
            scale = lpg_backward_magnitudes(torch, lpg, pe, grad, r, MAX_DEPTH)
            err = (got - want).abs()
            limit = LPG_BWD_TOL["atol"] + LPG_BWD_TOL["rtol"] * scale
            if not bool((err <= limit).all()):
                worst = (err / limit).max().item()
                raise RuntimeError(f"lpg backward r={r} B={b} {h}x{w} grad {name}: error "
                                   f"{worst!r} x its limit (max abs err {err.max().item()!r})")
            share = (err / scale.clamp_min(1e-30)).max().item()
            where = f"r={r} B={b} grid {h}x{w} grad {name}{' strided' if strided else ''}"
            if i >= len(TRAIN_SITES):
                print(f"lpg backward {where}: within tolerance, max abs err {err.max().item()!r}, "
                      f"largest error / terms' magnitude {share!r}")
                continue
            k = cuda_median_ms(lambda: lpg_cuda.lpg_backward_cuda(pe, grad, r, MAX_DEPTH))
            p = cuda_median_ms(lambda: lpg.lpg_backward_scaled(pe, grad, r, MAX_DEPTH))
            # As autograd launches it: right after another PyTorch kernel.
            a = cuda_median_ms(lambda: (one.add_(1),
                                        lpg_cuda.lpg_backward_cuda(pe, grad, r, MAX_DEPTH)))
            bound = lpg_backward_bound(b, h, w, r, dt.itemsize)[0]
            print(f"lpg backward {where}: max abs err {err.max().item()!r} (largest error / "
                  f"terms' magnitude {share!r}), kernel {k!r} ms, plain {p!r} ms (median of 50 "
                  f"samples of 10 calls); bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of "
                  f"it; a one-element add then the kernel {a!r} ms")
            acc = bwd.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "sites": []})
            acc["max_abs_err"] = max(acc["max_abs_err"], err.max().item())
            acc["ms"] += k
            acc["plain_ms"] += p
            acc["bound_ms"] += bound
            acc["sites"].append({"r": r, "ms": k, "bound_ms": bound, "after_add_ms": a})
        if i < len(TRAIN_SITES):
            k = cuda_median_ms(lambda: lpg_cuda.lpg_cuda(pe, r, MAX_DEPTH, torch.bfloat16))
            p = cuda_median_ms(lambda: lpg.lpg_scaled_reference(pe, r, MAX_DEPTH, torch.bfloat16))
            bound = lpg_bound(b, h, w, r, 2)[0]
            print(f"lpg forward train site r={r} B={b} grid {h}x{w}, bf16 out: kernel {k!r} ms, "
                  f"plain {p!r} ms; bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of it")
            fwd = [fwd[0] + k, fwd[1] + p, fwd[2] + bound]
    return bwd, fwd


def train_step_card_against_cpu(torch, Config, create_model, create_optimizer, TrainState,
                                make_train_step, reset_counts, counts,
                                encoder="densenet161_bts", against_float64=False, flavor="pt"):
    """Phase 7b (and 9c for other encoders): one f32 train step (TF32 off)
    of ``encoder``-BTS at full width, seeded weights, on a 2x416x544 batch,
    on the card and on the CPU: the loss at rtol 1e-4; exactly 3 forward and
    3 backward LPG launches and no fused dense launch on the card. Then every
    parameter and BN statistic after the step at atol 1e-4 (Adam normalises
    the update: a parameter moves by at most about lr = 1e-4).

    With ``against_float64`` a float64 step on the CPU is the reference in
    place of that atol: with BN in train mode the ResNet family's f32
    gradient is ill-conditioned (either f32 step's is off the float64 one by
    up to about 20% of a leaf's largest magnitude at this size, so where a
    gradient is near Adam's eps the two f32 updates part by more than 1e-4).
    The card's worst gradient error (each leaf's largest, over the larger of
    the leaf's largest magnitude and 1e-4 of the largest of all) and its
    worst state error after the step must be at most 2x the CPU f32 step's.

    ``flavor`` 'tf' (phase 10(d)) steps the TF graph, every BN frozen.

    Returns the launches and the names of the parameters set_misc froze on
    the card."""
    tcfg = Config(encoder=encoder, dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=2,
                  input_height=416, input_width=544, model_flavor=flavor)
    gen = torch.Generator().manual_seed(7)
    host = {"image": torch.randn(2, 416, 544, 3, generator=gen),
            "depth": torch.rand(2, 416, 544, 1, generator=gen) * 9.5 + 0.05,
            "focal": torch.full((2,), 518.8579)}
    runs = [("cuda", torch.float32), ("cpu", torch.float32)]
    if against_float64:
        runs.append(("cpu", torch.float64))
    out = {}
    for device, dtype in runs:
        model = create_model(tcfg).to(device=device, dtype=dtype)
        optimizer, _ = create_optimizer(tcfg, model, 1000)
        state = TrainState(model, optimizer)
        reset_counts()
        loss = make_train_step(tcfg)(state, {k: v.to(device=device, dtype=dtype)
                                             for k, v in host.items()})
        if device == "cuda":
            torch.cuda.synchronize()
            launched = counts()
            want = {"taps": 0, "eo": 0, "lpg": 3, "lpg_backward": 3}
            if launched != want:
                raise RuntimeError(f"{encoder} f32 train step: kernel launches {launched}, "
                                   f"expected {want}")
            frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
        grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        out[device, dtype] = (loss.cpu(), {k: v.detach().cpu() for k, v in
                                           model.state_dict().items()}, grads)
        del model, optimizer, state
    (gl, gs, gg), (cl, cs, cg) = out["cuda", torch.float32], out["cpu", torch.float32]
    torch.testing.assert_close(gl, cl, rtol=1e-4, atol=0)
    for key, want in cs.items():
        if not want.is_floating_point():
            torch.testing.assert_close(gs[key], want, rtol=0, atol=0)
    if against_float64:
        _, xs, xg = out["cpu", torch.float64]
        top = max(float(g.abs().max()) for g in xg.values())

        def grad_err(grads):
            return max((float((grads[n] - g).abs().max()) / max(float(g.abs().max()), 1e-4 * top),
                        n) for n, g in xg.items())

        def state_err(st):
            return max((float((st[k].double() - v).abs().max()), k) for k, v in xs.items()
                       if v.is_floating_point())

        errs = {"grad": (grad_err(gg), grad_err(cg)), "state": (state_err(gs), state_err(cs))}
        for what, (card, cpu) in errs.items():
            if card[0] > 2 * cpu[0]:
                raise RuntimeError(f"{encoder} f32 train step: the card's worst {what} error "
                                   f"against float64, {card}, exceeds 2x the CPU's, {cpu}")
        detail = (f"against a float64 CPU step, worst gradient error (of the leaf's scale) card "
                  f"{errs['grad'][0]!r}, CPU f32 {errs['grad'][1]!r}; worst state error card "
                  f"{errs['state'][0]!r}, CPU f32 {errs['state'][1]!r}")
    else:
        worst = (0.0, "")
        for key, want in cs.items():
            if want.is_floating_point():
                torch.testing.assert_close(gs[key], want, rtol=0, atol=1e-4,
                                           msg=lambda m: f"{key}: {m}")
                worst = max(worst, ((gs[key] - want).abs().max().item(), key))
        detail = (f"{len(cs)} state entries within atol 1e-4, largest diff {worst[0]!r} "
                  f"({worst[1]})")
    print(f"{encoder} ({flavor} graph) f32 train step, card against CPU: loss {gl.item()!r} "
          f"against {cl.item()!r}; {detail}; launches {launched}; {len(frozen)} parameters "
          "frozen")
    return launched, frozen


def write_nyu_frames(root, n=8, h=480, w=640):
    scene = os.path.join(root, "kitchen_0001")
    os.makedirs(scene)
    rng = np.random.default_rng(5)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(scene, f"rgb_{i:05d}.jpg"))
        Image.fromarray(rng.integers(500, 9000, (h, w), dtype=np.uint16)).save(
            os.path.join(scene, f"sync_depth_{i:05d}.png"))
        lines.append(f"kitchen_0001/rgb_{i:05d}.jpg kitchen_0001/sync_depth_{i:05d}.png 518.8579")
    manifest = os.path.join(root, "files.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def write_frames(directory, n, h, w, seed):
    """``n`` seeded RGB pngs of h x w in a new ``directory``."""
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"frame_{i:03d}.png"))
    return directory


def check_pngs(directory, n, shape, dtype):
    """``directory`` holds ``n`` pngs of this shape and dtype, none all 0."""
    names = sorted(os.listdir(directory))
    if len(names) != n:
        raise RuntimeError(f"{directory}: {len(names)} pngs, expected {n}: {names}")
    for name in names:
        a = np.asarray(Image.open(os.path.join(directory, name)))
        if a.dtype != dtype or a.shape != shape or a.max() == 0:
            raise RuntimeError(f"{name}: {a.dtype} {a.shape} max {a.max()}")
    return names


def write_manifest_head(manifest, name, n):
    """A manifest of the first ``n`` lines of ``manifest``, beside it."""
    with open(manifest) as f:
        lines = f.readlines()[:n]
    path = os.path.join(os.path.dirname(manifest), name)
    with open(path, "w") as f:
        f.writelines(lines)
    return path


BEST_NAME = re.compile(r"model-(\d+)-best_(\w+?)_(-?[0-9.]+)$")


def best_checkpoints(run_dir):
    """{metric: [(step, path), ...] by step} of the run's
    ``model-{step}-best_{metric}_{value:.5f}`` files."""
    out = {}
    for name in sorted(os.listdir(run_dir)):
        m = BEST_NAME.match(name)
        if m:
            out.setdefault(m.group(2), []).append((int(m.group(1)), os.path.join(run_dir, name)))
    return {k: sorted(v) for k, v in out.items()}


def check_device_metrics(torch, Config, device_eval, compute_errors, prepare_pred_gt):
    """Phase 8(a): ``make_batch_metrics`` on the card against the numpy
    protocol on the CPU, NYU 480x640 with the eigen crop and KITTI 352x1216
    with the garg crop, batch 8: seeded predictions with inf, nan and
    out-of-range values, seeded uint16 gt with zero holes. The meters on the
    card equal ``gt.astype(f32) / scale`` bit for bit; the mean measures
    within METRICS_TOL. Each batch's call (upload, metrics, the 10-number
    readback) timed on the host clock."""
    for dataset, h, w, crop in (("nyu", 480, 640, "eigen_crop"), ("kitti", 352, 1216, "garg_crop")):
        rng = np.random.default_rng(11)
        max_d = 10.0 if dataset == "nyu" else 80.0
        scale = device_eval.gt_scale(dataset)
        pred = rng.uniform(0.05, 1.2 * max_d, (8, h, w)).astype(np.float32)
        for value in (np.inf, -np.inf, np.nan, 0.0, -1.0, 1e4):
            pred.reshape(-1)[rng.integers(0, pred.size, 2000)] = value
        gt = rng.integers(1, int(max_d * scale), (8, h, w)).astype(np.uint16)
        gt[rng.random((8, h, w)) < 0.3] = 0
        meters = gt.astype(np.float32) / np.float32(scale)
        on_card = device_eval.upload_gt(gt, dataset, torch.device("cuda")).cpu().numpy()
        if not np.array_equal(on_card.view(np.uint32), meters.view(np.uint32)):
            raise RuntimeError(f"{dataset}: the gt meters on the card differ from numpy's")
        cfg = Config(dataset=dataset, min_depth_eval=1e-3, max_depth_eval=max_d, **{crop: True})
        batch_metrics = device_eval.make_batch_metrics(cfg)
        weights = np.ones(8, np.float32)
        preds = torch.from_numpy(pred).cuda()
        sums, count = batch_metrics(preds, gt, weights)
        host, n = np.zeros(9), 0
        for i in range(8):
            p, g, m = prepare_pred_gt(pred[i], meters[i], 1e-3, max_d, dataset, **{crop: True})
            if m.any():
                host += compute_errors(g[m], p[m])
                n += 1
        if count != n:
            raise RuntimeError(f"{dataset}: device counted {count} images, numpy {n}")
        np.testing.assert_allclose(sums / count, host / n, **METRICS_TOL)
        rel = np.max(np.abs(sums / count - host / n) / np.abs(host / n).clip(1e-30))
        batch_metrics(preds, gt, weights)
        t0 = time.perf_counter()
        for _ in range(10):
            batch_metrics(preds, gt, weights)
        ms = (time.perf_counter() - t0) * 100
        print(f"device metrics {dataset} 8x{h}x{w} {crop}: within rtol "
              f"{METRICS_TOL['rtol']}, atol {METRICS_TOL['atol']} of numpy (max rel diff "
              f"{float(rel)!r}); gt meters bit for bit; {ms!r} ms a batch on the host clock "
              f"(upload, metrics, readback)")


NYU_TEST_FRAMES = 654  # lines of train_test_inputs/nyudepthv2_test_files_with_gt.txt


def eval_throughput(model, cfg, manifest, run_online_eval, EvalLoader, batch=8):
    """Phase 8(d): run_online_eval's img/s over an eval split the size of
    NYU's (NYU_TEST_FRAMES lines, the frames of ``manifest`` at 480x640 in
    turn) at ``batch`` in bf16, with the device metrics on and off, in turns
    (on, off, off, on) after a warm-up over ``manifest`` itself; host clock
    around each run, which decodes every JPEG and PNG on the host. Beside
    them, the loader's own img/s over the same split (decoding and
    normalising the same batches, no forward) and its share of an eval's
    wall time with the device metrics on."""
    with open(manifest) as f:
        lines = f.readlines()
    split = os.path.join(os.path.dirname(manifest), "eval_split.txt")
    with open(split, "w") as f:
        f.writelines(lines[i % len(lines)] for i in range(NYU_TEST_FRAMES))
    cfg = cfg.replace(filenames_file_eval=manifest, eval_batch_size=batch,
                      compute_dtype="bfloat16")
    run_online_eval(model, cfg, verbose=False)
    cfg = cfg.replace(filenames_file_eval=split)
    runs = []
    for device_eval in (True, False, False, True):
        t0 = time.perf_counter()
        measures = run_online_eval(model, cfg.replace(device_eval=device_eval), verbose=False)
        runs.append((device_eval, NYU_TEST_FRAMES / (time.perf_counter() - t0)))
        if measures is None or not np.isfinite(measures).all():
            raise RuntimeError(f"eval over {NYU_TEST_FRAMES} frames: {measures}")
    rates = {f"device_eval_{'on' if on else 'off'}": statistics.mean(r for d, r in runs if d == on)
             for on in (True, False)}
    t0 = time.perf_counter()
    n = sum(int(b["weight"].sum()) for b in EvalLoader(cfg, "online_eval").batches())
    if n != NYU_TEST_FRAMES:
        raise RuntimeError(f"the EvalLoader gave {n} of {NYU_TEST_FRAMES} frames")
    rates["loader_only"] = n / (time.perf_counter() - t0)
    return rates, {"frames": NYU_TEST_FRAMES, "distinct_frames": len(lines),
                   "runs": [{"device_eval": d, "img_per_s": r} for d, r in runs],
                   "loader_share_of_eval_wall": rates["device_eval_on"] / rates["loader_only"]}


class Tee:
    """Writes to several streams (the console and a capture)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def train_args(manifest, eval_manifest, log_dir):
    """``configs/arguments_train_nyu.txt`` as it is, online-eval lines kept,
    with this run's data and eval split, one epoch, an eval every EVAL_FREQ
    steps at batch EVAL_BATCH and a log every 3 steps: (path of the args
    file, overrides)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                        "arguments_train_nyu.txt")
    data = os.path.dirname(manifest)
    return path, ["--data_path", data, "--gt_path", data, "--filenames_file", manifest,
                  "--data_path_eval", data, "--gt_path_eval", data,
                  "--filenames_file_eval", eval_manifest, "--log_directory", log_dir,
                  "--num_epochs", "1", "--eval_freq", str(EVAL_FREQ),
                  "--eval_batch_size", str(EVAL_BATCH), "--log_freq", "3"]


STEP_LINE = re.compile(r"\[epoch\]\[s/s_per_e/gs\]: \[\d+\]\[\d+/\d+/(\d+)\], lr: (\S+), "
                       r"loss: (\S+)")


def train_throughput(torch, Config, create_model, create_optimizer, TrainState, make_train_step,
                     batch, bf16, steps=10, warmup=3):
    """Train-step img/s of the NYU recipe (DenseNet161-BTS, 416x544 crops of
    raw 427x565 frames by device augmentation, AdamW) at ``batch``, in bf16
    autocast or f32 (TF32 off): host clock around ``steps`` steps after
    ``warmup`` steps, synchronised at both ends."""
    tcfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=batch,
                  input_height=416, input_width=544, device_augment=True,
                  compute_dtype="bfloat16" if bf16 else "float32")
    model = create_model(tcfg).cuda()
    optimizer, _ = create_optimizer(tcfg, model, 1000)
    state = TrainState(model, optimizer)
    step = make_train_step(tcfg)
    gen = torch.Generator().manual_seed(8)
    dev = {"image": torch.rand(batch, 427, 565, 3, generator=gen).cuda(),
           "depth": (torch.rand(batch, 427, 565, 1, generator=gen) * 9.5 + 0.05).cuda(),
           "focal": torch.full((batch,), 518.8579, device="cuda")}
    for _ in range(warmup):
        step(state, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(state, dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not torch.isfinite(loss):
        raise RuntimeError(f"train throughput batch {batch}: loss {loss.item()}")
    return batch * steps / elapsed, elapsed / steps * 1e3


def throughput(torch, model, batch, dense_impl, lpg_impl, iters=20, bf16=True):
    """Forward img/s of a DenseNet-BTS model with these dense and LPG impls."""
    model.encoder.dense_impl = dense_impl
    model.decoder.lpg_impl = lpg_impl
    return forward_rate(torch, model, batch, iters, bf16)


def forward_rate(torch, model, batch, iters=20, bf16=True):
    """Forward img/s at 480x640 at this batch, in bf16 autocast (or f32),
    CUDA events around iters runs."""
    x = torch.randn(batch, 3, 480, 640, device="cuda")
    focal = torch.full((batch,), 518.8579, device="cuda")
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
        for _ in range(3):
            model(x, focal)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x, focal)
        end.record()
        torch.cuda.synchronize()
    return batch * iters / (start.elapsed_time(end) / 1000.0)


def perturb(torch, model, gen):
    """Draw every conv bias (the TF graph's are zeros at init) and every BN's
    running statistics from ``gen``, so that a comparison reads them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.01)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model


def host_median_ms(fn, samples=20, warmup=3):
    """Median host-clock ms of one call of ``fn`` (CPU work)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cpu_name():
    """The host CPU's model: /proc/cpuinfo's 'model name' (x86), else lscpu's
    'Model name' (which also names ARM cores), with the core count."""
    name = None
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    if name is None:
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        m = re.search(r"^Model name:\s*(.+)$", out, re.M)
        name = m.group(1).strip() if m else "unnamed"
    return f"{name}, {os.cpu_count()} logical CPUs ({os.uname().machine})"


def check_lpg_ffi(torch, lpg, lpg_cpu, build):
    """Phase 10(f): the native CPU LPG built with g++, held against the plain
    versions at tests/test_lpg_ffi.py's shapes and tolerances (r = 8, 4, 2),
    then at the three NYU sites at batch 1 with TF-graph planes (theta at
    most pi/6): the forward at FFI_FWD_TOL, the gradient at LPG_BWD_TOL of
    its terms' magnitude (the sums run in another order). Each NYU site
    timed on the host, native against plain; ``impl="ffi"`` on a CUDA tensor
    must raise. Returns the record."""
    prebuilt = build.cpu_library_path().is_file()
    t0 = time.perf_counter()
    lib = build.build_cpu()
    built_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(12)

    def planes(b, h, w):
        logits = torch.randn(b, h, w, 3, generator=gen)
        return lpg.normalize_plane(lpg.decode_plane_eq(logits, MAX_DEPTH, math.pi / 6)
                                   ).contiguous()

    calls = (lpg_cpu.CALLS, lpg_cpu.BWD_CALLS)
    for r in (8, 4, 2):
        pe = planes(2, 3, 5)
        torch.testing.assert_close(lpg.local_planar_guidance(pe, r, impl="ffi"),
                                   lpg.lpg_reference(pe, r), **FFI_FWD_TOL)
        pe = planes(1, 2, 3)
        g = torch.randn(1, 2 * r, 3 * r, generator=gen)
        torch.testing.assert_close(lpg_cpu.lpg_backward_cpu(pe, g, r), lpg.lpg_backward(pe, g, r),
                                   **FFI_GRAD_TOL)
    rec = {"cpu": cpu_name(), "torch_threads": torch.get_num_threads(),
           "built_here": not prebuilt, "build_s": built_s, "library": os.path.basename(lib), "max_abs_err": 0.0, "grad_max_abs_err": 0.0,
           "ms": 0.0, "plain_ms": 0.0, "grad_ms": 0.0, "grad_plain_ms": 0.0, "sites": []}
    for r, h, w in NYU_SITES:
        pe = planes(1, h, w)
        g = torch.randn(1, h * r, w * r, generator=gen)
        got, want = lpg_cpu.lpg_cpu(pe, r), lpg.lpg_reference(pe, r)
        torch.testing.assert_close(got, want, **FFI_FWD_TOL)
        dgot, dwant = lpg_cpu.lpg_backward_cpu(pe, g, r), lpg.lpg_backward(pe, g, r)
        err = (dgot - dwant).abs()
        limit = LPG_BWD_TOL["atol"] + LPG_BWD_TOL["rtol"] * lpg_backward_magnitudes(
            torch, lpg, pe, g, r, 1.0)
        if not bool((err <= limit).all()):
            worst = (err / limit).max().item()
            raise RuntimeError(f"native CPU LPG gradient r={r}: error {worst!r} x its limit")
        site = {"r": r, "ms": host_median_ms(lambda: lpg_cpu.lpg_cpu(pe, r)),
                "plain_ms": host_median_ms(lambda: lpg.lpg_reference(pe, r)),
                "grad_ms": host_median_ms(lambda: lpg_cpu.lpg_backward_cpu(pe, g, r)),
                "grad_plain_ms": host_median_ms(lambda: lpg.lpg_backward(pe, g, r))}
        rec["max_abs_err"] = max(rec["max_abs_err"], (got - want).abs().max().item())
        rec["grad_max_abs_err"] = max(rec["grad_max_abs_err"], err.max().item())
        for k in ("ms", "plain_ms", "grad_ms", "grad_plain_ms"):
            rec[k] += site[k]
        rec["sites"].append(site)
        print(f"native CPU LPG r={r} B=1 grid {h}x{w}: forward {site['ms']!r} ms (plain "
              f"{site['plain_ms']!r}), gradient {site['grad_ms']!r} ms (plain "
              f"{site['grad_plain_ms']!r}); host clock, median of 20")
    rec["native_calls"] = (lpg_cpu.CALLS - calls[0], lpg_cpu.BWD_CALLS - calls[1])
    try:
        lpg.local_planar_guidance(planes(1, 2, 3).cuda(), 2, impl="ffi")
    except ValueError as e:
        rec["cuda_refused"] = str(e)
    else:
        raise RuntimeError("lpg_impl 'ffi' took a CUDA tensor")
    return rec


def main():
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from bts_tpu_torch.apps import live3d
    from bts_tpu_torch.cli import avg_checkpoints as cli_avg
    from bts_tpu_torch.cli import eval as cli_eval
    from bts_tpu_torch.cli import eval_with_pngs as cli_eval_with_pngs
    from bts_tpu_torch.cli import live3d as cli_live3d
    from bts_tpu_torch.cli import sequence as cli_sequence
    from bts_tpu_torch.cli import test as cli_test
    from bts_tpu_torch.cli import train as cli_train
    from bts_tpu_torch.config import Config, parse_args
    from bts_tpu_torch.data.loader import EvalLoader
    from bts_tpu_torch.evaluation import device_eval
    from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, compute_errors
    from bts_tpu_torch.evaluation.offline import read_ledger
    from bts_tpu_torch.evaluation.online import run_online_eval
    from bts_tpu_torch.evaluation.protocol import prepare_pred_gt
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.convert import load_checkpoint
    from bts_tpu_torch.models.encoders.densenet import DenseLayer
    from bts_tpu_torch.ops import _build, fused_dense, fused_dense_cuda, lpg, lpg_cpu, lpg_cuda
    from bts_tpu_torch.training import loop as train_loop
    from bts_tpu_torch.training.checkpoint import list_step_checkpoints
    from bts_tpu_torch.training.optim import create_optimizer
    from bts_tpu_torch.training.state import TrainState, make_train_step

    def reset_counts():
        lpg_cuda.LAUNCHES = lpg_cuda.BWD_LAUNCHES = 0
        fused_dense_cuda.TAPS_LAUNCHES = fused_dense_cuda.EO_LAUNCHES = 0

    def counts():
        return {"taps": fused_dense_cuda.TAPS_LAUNCHES, "eo": fused_dense_cuda.EO_LAUNCHES,
                "lpg": lpg_cuda.LAUNCHES, "lpg_backward": lpg_cuda.BWD_LAUNCHES}

    def check_counts(what, forwards, dense, layers=DENSE_LAYERS):
        """The launches since reset_counts(): ``layers`` (DenseNet161's 78)
        of the ``dense`` kernel, none of the other, 3 LPG, per forward, and
        no LPG backward."""
        got = counts()
        want = {"taps": 0, "eo": 0, "lpg": 3 * forwards, "lpg_backward": 0}
        want[dense] = layers * forwards
        if got != want:
            raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")
        return got

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = _build.build(ptxas_report=True)
    _build.load_library()
    print(f"built {lib_path} in {time.perf_counter() - t0:.2f} s")

    phase("3 kernels against plain")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lpg_res = check_lpg(torch, lpg_cuda, lpg)
    for key, (err, k, p, bound, u) in lpg_res.items():
        print(f"lpg {key}, three NYU sites at B=8: kernel {k!r} ms, plain {p!r} ms, unfused "
              f"{u!r} ms, bound {bound!r} ms by bytes ({bound / k:.2%}), max_abs_err {err!r}")
    dense = check_dense_kernels(torch, fused_dense, fused_dense_cuda, DenseLayer)
    dense121 = check_densenet121_kernels(torch, fused_dense, fused_dense_cuda, DenseLayer)
    for (impl, name, b), r in dense121.items():
        print(f"densenet121 dense {impl} {name}, 8 shapes summed at B={b}: kernel {r['ms']!r} ms, "
              f"max_abs_err {r['max_abs_err']!r}")
    for (impl, name, b), r in dense.items():
        layer = (f", layer bound {r['layer_bound_ms']!r} ms "
                 f"({r['layer_bound_ms'] / r['ms']:.2%})" if impl == "eo" else "")
        print(f"dense {impl} {name}, 8 shapes summed at B={b}: kernel {r['ms']!r} ms, plain "
              f"{r['plain_ms']!r} ms, cuDNN chain {r['cudnn_chain_ms']!r} ms, bound "
              f"{r['bound_ms']!r} ms ({r['bound_ms'] / r['ms']:.2%}){layer}, max_abs_err "
              f"{r['max_abs_err']!r}")

    phase("4 port on the card against the port on the CPU, f32")
    gen = torch.Generator().manual_seed(1)
    f32_path = {}  # the launches of each f32 DenseNet161 NYU forward, by its dense kernel
    # (name, encoder, dataset, max_depth, (B,3,H,W), focal, dense layers)
    f32_forwards = [
        ("densenet161 nyu 96x128", "densenet161_bts", "nyu", 10.0, (1, 3, 96, 128), 518.8579, 78),
        ("densenet121 nyu 480x640", "densenet121_bts", "nyu", 10.0, (1, 3, 480, 640), 518.8579,
         58),
        ("densenet161 kitti 352x1216", "densenet161_bts", "kitti", 80.0, (1, 3, 352, 1216),
         721.5377, 78),
    ]
    for label, encoder, dataset, max_depth, shape, f, layers in f32_forwards:
        fcfg = Config(encoder=encoder, dataset=dataset, max_depth=max_depth, bts_size=512)
        x = torch.randn(*shape, generator=gen)
        focal = torch.tensor([f])
        cpu_model, gpu_model = create_model(fcfg).eval(), create_model(fcfg).cuda().eval()
        with torch.inference_mode():
            want = cpu_model(x, focal)
        for dense_impl, kernel in (("auto", "taps"), ("eo", "eo")):
            gpu_model.encoder.dense_impl = dense_impl
            reset_counts()
            with torch.inference_mode():
                got = gpu_model(x.cuda(), focal.cuda())
                torch.cuda.synchronize()
            launched = check_counts(f"f32 forward {label}, dense_impl {dense_impl}", 1, kernel,
                                    layers)
            if label.startswith("densenet161 nyu"):
                f32_path[kernel] = launched
            for name, g, w in zip(["lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth"], got, want,
                                  strict=True):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4)
                print(f"{label} dense_impl {dense_impl} {name}: max abs diff GPU vs CPU "
                      f"{(g.cpu() - w).abs().max().item()!r}")
            print(f"{label} dense_impl {dense_impl}: launches {launched}")
        del cpu_model, gpu_model
    cfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=10.0, bts_size=512)

    phase("5 serving path: bts_tpu_torch.cli.test.main")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        n_frames, batch = 8, 4
        forwards = math.ceil(n_frames / batch)
        manifest = write_nyu_frames(os.path.join(tmp, "data"), n_frames)
        argv = [
            "--encoder", "densenet161_bts", "--dataset", "nyu", "--max_depth", "10",
            "--input_height", "480", "--input_width", "640",
            "--compute_dtype", "bfloat16", "--eval_batch_size", str(batch),
            "--data_path", os.path.join(tmp, "data"), "--filenames_file", manifest,
            "--model_name", "chip_smoke",
        ]
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            rc = cli_test.main(argv)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            serving = check_counts("cli.test", forwards, "taps")
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"cli.test.main returned {rc}")
        raw = os.path.join(tmp, "result_chip_smoke", "raw")
        pngs = sorted(os.listdir(raw))
        if len(pngs) != n_frames:
            raise RuntimeError(f"expected {n_frames} raw pngs, found {pngs}")
        for p in pngs:
            a = np.asarray(Image.open(os.path.join(raw, p)))
            if a.dtype != np.uint16 or a.shape != (480, 640) or a.max() == 0:
                raise RuntimeError(f"{p}: {a.dtype} {a.shape} max {a.max()}")
    print(f"{n_frames} raw pngs, {forwards} forwards, kernel launches {serving}, "
          f"{elapsed:.1f} s including model build")

    phase("6 bf16 against f32, the eo path, throughput")
    model = create_model(cfg).cuda().eval()
    x = torch.randn(4, 3, 480, 640, generator=gen).cuda()
    focal = torch.full((4,), 518.8579, device="cuda")
    with torch.inference_mode():
        f32 = model(x, focal)[4]
        depth = {}
        for dense_impl in ("auto", "eo"):
            model.encoder.dense_impl = dense_impl
            reset_counts()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                depth[dense_impl] = model(x, focal)[4]
            torch.cuda.synchronize()
            if dense_impl == "eo":
                eo_path = check_counts("bf16 forward, dense_impl eo", 1, "eo")
    for dense_impl, bf16 in depth.items():
        if not (torch.isfinite(f32).all() and torch.isfinite(bf16).all()):
            raise RuntimeError(f"non-finite depth (dense_impl {dense_impl})")
        if tuple(bf16.shape) != (4, 1, 480, 640):
            raise RuntimeError(f"depth shape {tuple(bf16.shape)}")
        diff = (bf16 - f32).abs().max().item()
        print(f"bf16 (dense_impl {dense_impl}) vs f32 final depth, 4x480x640: "
              f"max abs diff {diff!r} m")
        if diff >= 0.15:
            raise RuntimeError(f"bf16 (dense_impl {dense_impl}) vs f32 max abs diff {diff} m "
                               ">= 0.15 m")
    # (dense_impl, lpg_impl): dense layers plain / taps kernel / eo kernel,
    # and the plain LPG; run in turns forward then backward, averaged.
    impls = [("plain", "auto"), ("auto", "auto"), ("eo", "auto"), ("auto", "xla")]
    for b in (1, 8):
        runs = [(i, throughput(torch, model, b, *i)) for i in impls + impls[::-1]]
        print(f"batch {b} runs in turn: {runs!r}")
        for i in impls:
            rate = statistics.mean(r for j, r in runs if j == i)
            print(f"forward bf16 480x640 batch {b}: dense_impl {i[0]}, lpg_impl {i[1]}: "
                  f"{rate!r} img/s ({smi})")
    # f32, cli.test's default dtype (TF32 off, as phase 3 set it).
    impls = [("plain", "auto"), ("auto", "auto"), ("eo", "auto")]
    runs = [(i, throughput(torch, model, 8, *i, iters=10, bf16=False))
            for i in impls + impls[::-1]]
    print(f"f32 batch 8 runs in turn: {runs!r}")
    for i in impls:
        rate = statistics.mean(r for j, r in runs if j == i)
        print(f"forward f32 480x640 batch 8: dense_impl {i[0]}: {rate!r} img/s ({smi})")

    del model
    torch.cuda.empty_cache()

    phase("7 train: LPG backward kernel, train step against the CPU, cli.train, img/s")
    lpg_bwd, lpg_fwd_train = check_lpg_train(torch, lpg_cuda, lpg)
    floor = launch_floor_ms(torch)
    for name, r in lpg_bwd.items():
        k, bound = r["ms"], r["bound_ms"]
        print(f"lpg backward, grad {name}, three train sites at B={TRAIN_BATCH}: kernel {k!r} ms, "
              f"plain {r['plain_ms']!r} ms, bound {bound!r} ms by bytes ({bound / k:.2%}), three "
              f"launch floors {3 * floor!r} ms, max_abs_err {r['max_abs_err']!r}")
    print(f"launch floor (a one-element in-place add, median of 50 samples of 10 calls): "
          f"{floor!r} ms ({smi})")
    print(f"lpg forward, bf16 out, three train sites at B={TRAIN_BATCH}: kernel "
          f"{lpg_fwd_train[0]!r} ms, plain {lpg_fwd_train[1]!r} ms, bound {lpg_fwd_train[2]!r} ms")
    train_step_card_against_cpu(torch, Config, create_model, create_optimizer, TrainState,
                                make_train_step, reset_counts, counts)

    # The slice's main path: bts_tpu_torch.cli.train.main at full width on the
    # recipe, its online eval included. Phase 8 reads what it wrote; its
    # directory lives until then.
    train_steps = 6
    train_tmp = tempfile.TemporaryDirectory()
    tmp = train_tmp.name
    data = os.path.join(tmp, "data")
    manifest = write_nyu_frames(data, TRAIN_BATCH * train_steps)
    eval_manifest = write_manifest_head(manifest, "eval.txt", EVAL_FRAMES)
    log_dir = os.path.join(tmp, "logs")
    args_path, overrides = train_args(manifest, eval_manifest, log_dir)
    # Each online eval's forwards, kernel launches and measures, as the loop
    # calls run_online_eval.
    evals = []
    real_eval = train_loop.run_online_eval

    def counted_eval(model, cfg, loader, forward):
        calls = []

        def fwd(image, focal):
            calls.append(1)
            return forward(image, focal)

        before = counts()
        measures = real_eval(model, cfg, loader, fwd)
        evals.append((len(calls), {k: v - before[k] for k, v in counts().items()}, measures))
        return measures

    capture = io.StringIO()
    os.chdir(tmp)
    train_loop.run_online_eval = counted_eval
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
            rc = cli_train.main(["@" + args_path, *overrides])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        train_path = counts()
    finally:
        train_loop.run_online_eval = real_eval
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"cli.train.main returned {rc}")
    steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(capture.getvalue())]
    if [gs for gs, _ in steps] != list(range(1, train_steps + 1)):
        raise RuntimeError(f"cli.train logged steps {steps}, expected 1..{train_steps}")
    if not all(math.isfinite(loss) for _, loss in steps):
        raise RuntimeError(f"cli.train logged a non-finite loss: {steps}")
    eval_forwards = sum(f for f, _, _ in evals)
    if (train_path["lpg_backward"] != 3 * train_steps
            or train_path["lpg"] < 3 * (train_steps + eval_forwards)):
        raise RuntimeError(f"cli.train: kernel launches {train_path}, expected 3 LPG backward a "
                           f"step and at least 3 LPG forward a step and an eval forward")
    run_dir = os.path.join(log_dir, "bts_nyu_v2_tpu")
    best = best_checkpoints(run_dir)
    if sorted(best) != sorted(EVAL_METRICS) or list_step_checkpoints(run_dir):
        raise RuntimeError(f"cli.train --do_online_eval wrote {sorted(os.listdir(run_dir))}: "
                           "expected a best checkpoint per metric and no model-N")
    print(f"cli.train: {train_steps} steps at batch {TRAIN_BATCH} (bf16, device_augment), "
          f"losses {[loss for _, loss in steps]!r}, {len(evals)} online evals, kernel launches "
          f"{train_path}, {elapsed:.1f} s including model build; wrote "
          f"{sorted(os.listdir(run_dir))}")

    # Train img/s (warm-up steps left out). Batch 16 is BENCH_TRAIN_r05.json's;
    # where it does not fit, the largest of 12 and 8 that does.
    train_rates = {}
    for bf16, batches in ((True, (TRAIN_BATCH,)), (True, (16, 12, 8)), (False, (TRAIN_BATCH,))):
        for b in batches:
            key = f"{'bf16' if bf16 else 'f32'}_b{b}"
            try:
                rate, ms = train_throughput(torch, Config, create_model, create_optimizer,
                                            TrainState, make_train_step, b, bf16)
            except torch.cuda.OutOfMemoryError as e:
                print(f"train step {key}: out of memory ({e})")
                torch.cuda.empty_cache()
                continue
            torch.cuda.empty_cache()
            train_rates[key] = rate
            print(f"train step {key} 416x544 device_augment: {rate!r} img/s, {ms!r} ms a step "
                  f"(10 steps after 3 warm-up; {smi})")
            break
        else:
            raise RuntimeError(f"train step: no batch of {batches} fits")
    print(json.dumps({"train_img_per_s": train_rates, "device": smi}))

    phase("8 eval: device metrics, cli.train's online eval, cli.eval, cli.eval_with_pngs, img/s")
    check_device_metrics(torch, Config, device_eval, compute_errors, prepare_pred_gt)

    # (b) cli.train's online evals: each forward 78 taps and 3 LPG launches,
    # no backward; a fresh model on a best checkpoint gives the logged measures.
    fwd_per_eval = math.ceil(EVAL_FRAMES / EVAL_BATCH)
    per_eval = {"taps": DENSE_LAYERS * fwd_per_eval, "eo": 0, "lpg": 3 * fwd_per_eval,
                "lpg_backward": 0}
    if len(evals) != train_steps // EVAL_FREQ:
        raise RuntimeError(f"cli.train ran {len(evals)} online evals, expected "
                           f"{train_steps // EVAL_FREQ}")
    for forwards, launched, measures in evals:
        if forwards != fwd_per_eval or launched != per_eval or not np.isfinite(measures).all():
            raise RuntimeError(f"online eval: {forwards} forwards, launches {launched} (expected "
                               f"{fwd_per_eval} and {per_eval}), measures {measures}")
    eval_cfg = parse_args(["@" + args_path, *overrides])
    step, ckpt = best["d1"][-1]
    fresh = create_model(eval_cfg).cuda()
    fresh.load_state_dict(load_checkpoint(ckpt), strict=True)
    reset_counts()
    got = run_online_eval(fresh, eval_cfg, verbose=False)
    if counts() != per_eval:
        raise RuntimeError(f"online eval of a fresh model: launches {counts()}, expected {per_eval}")
    logged = evals[step // EVAL_FREQ - 1][2]
    np.testing.assert_allclose(got, logged, rtol=1e-5, atol=0)
    print(f"online eval in cli.train: {len(evals)} evals of {fwd_per_eval} forwards, launches "
          f"{per_eval} each; a fresh model on {os.path.basename(ckpt)} gives {got.tolist()!r}, "
          f"the loop logged {logged.tolist()!r} at step {step} (max rel diff "
          f"{float(np.max(np.abs(got - logged) / np.abs(logged).clip(1e-30)))!r})")

    # (c) cli.eval over a run dir of model-N files (no code snapshot), twice;
    # cli.test from a best checkpoint, then cli.eval_with_pngs over its pngs.
    eval_logs = os.path.join(tmp, "eval_logs")
    eval_run = os.path.join(eval_logs, "evalrun")
    os.makedirs(eval_run)
    by_step = {s: p for paths in best.values() for s, p in paths}
    past = time.time() - 120  # older than the maturity guard's 60 s
    for i, s in enumerate((EVAL_FREQ, 2 * EVAL_FREQ)):
        dst = os.path.join(eval_run, f"model-{s}")
        shutil.copyfile(by_step.get(s, ckpt), dst)
        os.utime(dst, (past, past))
    eval_argv = ["@" + args_path, *overrides, "--log_directory", eval_logs,
                 "--model_name", "evalrun"]
    launched = []
    for _ in range(2):
        reset_counts()
        capture = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
            rc = cli_eval.main(eval_argv)
        launched.append((counts(), capture.getvalue().count(
            f"Computing errors for {EVAL_FRAMES} eval samples")))
        if rc != 0:
            raise RuntimeError(f"cli.eval returned {rc}")
    ledger = read_ledger(eval_run)
    twice = {k: 2 * v for k, v in per_eval.items()}
    if ledger != [EVAL_FREQ, 2 * EVAL_FREQ] or launched != [(twice, 2), (dict.fromkeys(twice, 0), 0)]:
        raise RuntimeError(f"cli.eval: ledger {ledger}, launches and tables {launched}")
    print(f"cli.eval: evaluated model-{EVAL_FREQ} and model-{2 * EVAL_FREQ} (launches "
          f"{launched[0][0]}), ledger {ledger}; a second call evaluated nothing")

    # A copy outside the run dir: inside it, cli.test would re-exec the run's
    # code snapshot, whose kernels count launches in modules of their own.
    served = shutil.copyfile(ckpt, os.path.join(tmp, "best_d1.pth"))
    os.chdir(tmp)
    try:
        rc = cli_test.main([
            "--encoder", "densenet161_bts", "--dataset", "nyu", "--max_depth", "10",
            "--compute_dtype", "bfloat16", "--eval_batch_size", str(EVAL_BATCH),
            "--data_path", data, "--filenames_file", eval_manifest,
            "--model_name", "chip_smoke_trained", "--checkpoint_path", served])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"cli.test from {ckpt} returned {rc}")
    raw = os.path.join(tmp, "result_chip_smoke_trained", "raw")
    pngs = sorted(os.listdir(raw))
    for p in pngs:
        a = np.asarray(Image.open(os.path.join(raw, p)))
        if a.dtype != np.uint16 or a.shape != (480, 640) or a.max() == 0:
            raise RuntimeError(f"{p}: {a.dtype} {a.shape} max {a.max()}")
    if len(pngs) != EVAL_FRAMES:
        raise RuntimeError(f"cli.test from {ckpt}: {pngs}")
    capture = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
        rc = cli_eval_with_pngs.main(["--pred_path", raw, "--gt_path", data, "--dataset", "nyu",
                                      "--min_depth_eval", "1e-3", "--max_depth_eval", "10",
                                      "--eigen_crop"])
    table = re.search(r"Computing errors for (\d+) eval samples\n.*\n(.*)\n", capture.getvalue())
    values = [float(v) for v in table.group(2).split(",")] if table else []
    if rc != 0 or int(table.group(1)) != EVAL_FRAMES or len(values) != 9 or not all(
            math.isfinite(v) for v in values):
        raise RuntimeError(f"cli.eval_with_pngs: {capture.getvalue()!r}")
    print(f"cli.test served {len(pngs)} uint16 480x640 pngs from {os.path.basename(ckpt)}; "
          f"cli.eval_with_pngs scored {EVAL_FRAMES}: {values!r}")

    # (d) Eval img/s, host decoding included.
    eval_rates, eval_info = eval_throughput(fresh, eval_cfg, manifest, run_online_eval,
                                            EvalLoader)
    for key, rate in eval_rates.items():
        print(f"online eval 480x640 bf16 batch 8 over {NYU_TEST_FRAMES} frames, {key}: {rate!r} "
              f"img/s (host JPEG/PNG decoding {'alone' if key == 'loader_only' else 'and the card'}"
              f"; {smi})")
    print(f"the loader's share of an eval's wall time (device metrics on): "
          f"{eval_info['loader_share_of_eval_wall']!r}")
    print(json.dumps({"eval_img_per_s": eval_rates, **eval_info, "device": smi}))
    del fresh
    train_tmp.cleanup()

    phase("9 encoder zoo: card against CPU, cli.test, cli.train, averaging, demos")
    no_dense = {"taps": 0, "eo": 0}

    def expect(what, lpg=0, lpg_backward=0, taps=0):
        got = counts()
        want = {"taps": taps, "eo": 0, "lpg": lpg, "lpg_backward": lpg_backward}
        if got != want:
            raise RuntimeError(f"{what}: kernel launches {got}, expected {want}")
        return got

    # (a) Each encoder's f32 forward (TF32 off) at full width, batch 1, on the
    # card against the CPU: 3 LPG and no dense launches; bf16 img/s at batch 8.
    zoo_launches = {}
    zoo_rates = {}
    zoo_forwards = [(e, "nyu", 10.0, (1, 3, 480, 640), 518.8579) for e in ZOO_ENCODERS]
    zoo_forwards.append(("resnext50_bts", "kitti", 80.0, (1, 3, 352, 1216), 721.5377))
    for encoder, dataset, max_depth, shape, f in zoo_forwards:
        label = f"{encoder} {dataset} {shape[2]}x{shape[3]}"
        fcfg = Config(encoder=encoder, dataset=dataset, max_depth=max_depth, bts_size=512)
        x = torch.randn(*shape, generator=gen)
        focal = torch.tensor([f])
        model = create_model(fcfg).eval()
        with torch.inference_mode():
            want = model(x, focal)
        model.cuda()
        reset_counts()
        with torch.inference_mode():
            got = model(x.cuda(), focal.cuda())
            torch.cuda.synchronize()
        zoo_launches[label] = expect(f"f32 forward {label}", lpg=3)
        diffs = []
        for name, g, w in zip(["lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth"], got, want,
                              strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4,
                                       msg=lambda m: f"{label} {name}: {m}")
            diffs.append((g.cpu() - w).abs().max().item())
        print(f"{label} f32, card against CPU: max abs diffs (lpg8x8, lpg4x4, lpg2x2, reduc1x1, "
              f"depth) {diffs!r} within rtol 1e-3, atol 1e-4; launches {zoo_launches[label]}")
        if dataset == "nyu":
            zoo_rates[encoder] = forward_rate(torch, model, 8)
            print(f"forward bf16 480x640 batch 8 {encoder}: {zoo_rates[encoder]!r} img/s ({smi})")
        del model, got, want
        torch.cuda.empty_cache()

    zoo_tmp = tempfile.TemporaryDirectory()
    tmp = zoo_tmp.name
    data = os.path.join(tmp, "data")
    manifest = write_nyu_frames(data, TRAIN_BATCH * ZOO_TRAIN_STEPS)
    serve_manifest = write_manifest_head(manifest, "serve.txt", EVAL_FRAMES)
    serve_forwards = math.ceil(EVAL_FRAMES / EVAL_BATCH)

    def serve(encoder, checkpoint, name):
        """cli.test over the first EVAL_FRAMES frames in bf16: 3 LPG and no
        dense launches a forward, EVAL_FRAMES uint16 480x640 pngs."""
        os.chdir(tmp)
        try:
            reset_counts()
            rc = cli_test.main([
                "--encoder", encoder, "--dataset", "nyu", "--max_depth", "10",
                "--compute_dtype", "bfloat16", "--eval_batch_size", str(EVAL_BATCH),
                "--data_path", data, "--filenames_file", serve_manifest,
                "--model_name", name, "--checkpoint_path", checkpoint])
            torch.cuda.synchronize()
            launched = expect(f"cli.test {encoder}", lpg=3 * serve_forwards)
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"cli.test {encoder} from {checkpoint} returned {rc}")
        check_pngs(os.path.join(tmp, f"result_{name}", "raw"), EVAL_FRAMES, (480, 640),
                   np.uint16)
        return launched

    # (b) cli.test with ResNet-50 from a reference trainer's save: DDP
    # prefix, and torchvision's fc, which the reference never calls.
    reference = create_model(Config(encoder="resnet50_bts", bts_size=512, seed=3))
    state = {"module." + k: v for k, v in reference.state_dict().items()}
    fc_gen = torch.Generator().manual_seed(3)
    state["module.encoder.base_model.fc.weight"] = torch.randn(1000, 2048, generator=fc_gen)
    state["module.encoder.base_model.fc.bias"] = torch.randn(1000, generator=fc_gen)
    reference_pth = os.path.join(tmp, "resnet50_reference.pth")
    torch.save({"model": state, "global_step": 0}, reference_pth)
    del reference, state
    zoo_launches["cli.test resnet50"] = serve("resnet50_bts", reference_pth, "zoo_resnet50")
    print(f"cli.test resnet50_bts from a reference save with fc: {EVAL_FRAMES} raw pngs, "
          f"launches {zoo_launches['cli.test resnet50']}")

    # (c) cli.train with ResNeXt-50 on the recipe (416x544, batch 4, bf16,
    # --device_augment), periodic model-N files in place of the online eval.
    log_dir = os.path.join(tmp, "logs")
    args_path, overrides = train_args(manifest, serve_manifest, log_dir)
    overrides += ["--encoder", "resnext50_bts", "--no-do_online_eval", "--save_freq", "2",
                  "--model_name", "zoo_resnext50"]
    capture = io.StringIO()
    os.chdir(tmp)
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
            rc = cli_train.main(["@" + args_path, *overrides])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        zoo_train = counts()
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"cli.train resnext50_bts returned {rc}")
    steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(capture.getvalue())]
    if [gs for gs, _ in steps] != list(range(1, ZOO_TRAIN_STEPS + 1)) or not all(
            math.isfinite(loss) for _, loss in steps):
        raise RuntimeError(f"cli.train resnext50_bts logged {steps}")
    if (zoo_train["lpg_backward"] != 3 * ZOO_TRAIN_STEPS
            or zoo_train["lpg"] < 3 * ZOO_TRAIN_STEPS
            or {k: zoo_train[k] for k in no_dense} != no_dense):
        raise RuntimeError(f"cli.train resnext50_bts: kernel launches {zoo_train}, expected 3 "
                           "LPG backward and at least 3 LPG forward a step, no dense")
    zoo_launches["cli.train resnext50"] = zoo_train
    zoo_run = os.path.join(log_dir, "zoo_resnext50")
    zoo_ckpts = list_step_checkpoints(zoo_run)
    if sorted(zoo_ckpts) != [2, 4]:
        raise RuntimeError(f"cli.train resnext50_bts wrote {sorted(os.listdir(zoo_run))}")
    print(f"cli.train resnext50_bts: {ZOO_TRAIN_STEPS} steps at batch {TRAIN_BATCH} (bf16, "
          f"device_augment), losses {[loss for _, loss in steps]!r}, kernel launches "
          f"{zoo_train}, {elapsed:.1f} s including model build; wrote model-2 and model-4")

    for encoder in ("resnet50_bts", "mobilenetv2_bts"):
        launched, frozen = train_step_card_against_cpu(
            torch, Config, create_model, create_optimizer, TrainState, make_train_step,
            reset_counts, counts, encoder=encoder, against_float64=True)
        zoo_launches[f"train step {encoder}"] = launched
        base = "encoder.base_model."
        if encoder == "mobilenetv2_bts":
            ok = not frozen
        else:
            ok = ({base + "conv1.weight", base + "bn1.weight", base + "layer1.0.bn2.weight"}
                  <= frozen and base + "layer1.0.downsample.1.weight" not in frozen)
        if not ok:
            raise RuntimeError(f"{encoder}: set_misc froze {sorted(frozen)}")

    # (d) cli.avg_checkpoints over (c)'s model-2 and model-4, then cli.test
    # from the average.
    avg_path = os.path.join(tmp, "avg.pth")
    if cli_avg.main(["--out", avg_path, zoo_ckpts[2], zoo_ckpts[4]]) != 0:
        raise RuntimeError("cli.avg_checkpoints failed")
    a, b = (load_checkpoint(zoo_ckpts[s]) for s in (2, 4))
    avg = load_checkpoint(avg_path)
    for k, v in avg.items():
        want = ((a[k].double() + b[k].double()) / 2).to(v.dtype) if v.is_floating_point() else a[k]
        if not torch.equal(v, want):
            raise RuntimeError(f"cli.avg_checkpoints: {k} is not the mean of the two files")
    del a, b, avg
    zoo_launches["cli.test resnext50 average"] = serve("resnext50_bts", avg_path, "zoo_avg")
    print(f"cli.avg_checkpoints: {len(load_checkpoint(avg_path))} tensors, each the float64 "
          f"mean cast back; cli.test from it: {EVAL_FRAMES} raw pngs, launches "
          f"{zoo_launches['cli.test resnext50 average']}")

    # (e) The demos on the averaged ResNeXt-50: cli.sequence over frames whose
    # size is no multiple of 32, cli.live3d headless; then the live3d
    # depth_fn's latency at batch 1.
    demo_args = ["--encoder", "resnext50_bts", "--dataset", "nyu", "--max_depth", "10",
                 "--checkpoint_path", avg_path]
    seq_dir = write_frames(os.path.join(tmp, "seq"), SEQUENCE_FRAMES, *SEQUENCE_HW, seed=9)
    reset_counts()
    rc = cli_sequence.main(["--image_dir", seq_dir, "--out_dir", os.path.join(tmp, "seq_out"),
                            *demo_args])
    torch.cuda.synchronize()
    zoo_launches["cli.sequence"] = expect("cli.sequence", lpg=3 * SEQUENCE_FRAMES)
    if rc != 0:
        raise RuntimeError(f"cli.sequence returned {rc}")
    check_pngs(os.path.join(tmp, "seq_out"), 4 * SEQUENCE_FRAMES, (*SEQUENCE_HW, 3), np.uint8)
    live_dir = write_frames(os.path.join(tmp, "live"), LIVE3D_FRAMES, 480, 640, seed=10)
    reset_counts()
    rc = cli_live3d.main(["--image_dir", live_dir, "--out_dir", os.path.join(tmp, "live_out"),
                          *demo_args])
    torch.cuda.synchronize()
    zoo_launches["cli.live3d"] = expect("cli.live3d", lpg=3 * LIVE3D_FRAMES)
    if rc != 0:
        raise RuntimeError(f"cli.live3d returned {rc}")
    check_pngs(os.path.join(tmp, "live_out"), 3 * LIVE3D_FRAMES, (480, 640, 3), np.uint8)
    print(f"cli.sequence: {SEQUENCE_FRAMES} frames of {SEQUENCE_HW}, launches "
          f"{zoo_launches['cli.sequence']}; cli.live3d: {LIVE3D_FRAMES} frames, "
          f"{3 * LIVE3D_FRAMES} renders, launches {zoo_launches['cli.live3d']}")
    zoo_tmp.cleanup()

    live3d_ms = {}
    rgb = np.random.default_rng(11).integers(0, 255, (480, 640, 3), dtype=np.uint8)
    for encoder, dtype, layers in (("densenet161_bts", "float32", DENSE_LAYERS),
                                   ("densenet161_bts", "bfloat16", DENSE_LAYERS),
                                   ("mobilenetv2_bts", "float32", 0),
                                   ("resnext50_bts", "bfloat16", 0)):
        depth_fn = live3d.make_depth_fn(Config(encoder=encoder, bts_size=512,
                                               compute_dtype=dtype), "cuda")
        reset_counts()
        depth = depth_fn(rgb)
        expect(f"live3d depth_fn {encoder} {dtype}", lpg=3, taps=layers)
        if depth.shape != (480, 640) or not np.isfinite(depth).all():
            raise RuntimeError(f"live3d depth_fn {encoder}: {depth.shape}")
        for _ in range(3):
            depth_fn(rgb)
        frame_ms, cloud_ms = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            depth_fn(rgb)  # returns host numpy: the card is done
            t1 = time.perf_counter()
            live3d.frame_to_cloud(rgb, depth_fn)
            frame_ms.append((t1 - t0) * 1e3)
            cloud_ms.append((time.perf_counter() - t1) * 1e3)
        key = f"{encoder}_{dtype}"
        live3d_ms[key] = {"depth_fn_ms": statistics.median(frame_ms),
                          "frame_to_cloud_ms": statistics.median(cloud_ms)}
        print(f"live3d depth_fn {encoder} {dtype} 480x640 batch 1: median "
              f"{live3d_ms[key]['depth_fn_ms']!r} ms a frame (host clock: upload, forward, "
              f"readback; 20 frames after 4), frame_to_cloud (depth and the numpy cloud) "
              f"{live3d_ms[key]['frame_to_cloud_ms']!r} ms ({smi})")
        del depth_fn
        torch.cuda.empty_cache()
    print(json.dumps({"zoo_forward_bf16_b8_img_per_s": zoo_rates, "live3d_ms": live3d_ms,
                      "zoo_launches": zoo_launches, "device": smi}))

    phase("10 TF graph: NYU and KITTI card against CPU, cli.test, train, img/s; the CPU LPG")
    tf_launches = {}
    names = ["lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth"]
    # (a, b) The TF graph's f32 forward on the card against the CPU; at NYU
    # also in bf16. Biases and BN statistics drawn, so the comparison reads
    # them; every encoder BN has eps 1.1e-5, which the taps kernels fold.
    tf_forwards = [("nyu 480x640", "nyu", 10.0, (1, 3, 480, 640), 518.8579),
                   ("kitti 352x1216", "kitti", 80.0, (1, 3, 352, 1216), 721.5377)]
    for label, dataset, max_depth, shape, f in tf_forwards:
        tcfg = Config(encoder="densenet161_bts", dataset=dataset, max_depth=max_depth,
                      bts_size=512, model_flavor="tf")
        model = perturb(torch, create_model(tcfg), gen).eval()
        eps = {m.eps for m in model.encoder.modules() if isinstance(m, torch.nn.BatchNorm2d)}
        if eps != {1.1e-5} or "decoder.get_depth.0.bias" not in model.state_dict():
            raise RuntimeError(f"not the TF graph: encoder BN eps {eps}")
        x = torch.randn(*shape, generator=gen)
        focal = torch.tensor([f])
        with torch.inference_mode():
            want = model(x, focal)
        model.cuda()
        reset_counts()
        with torch.inference_mode():
            got = model(x.cuda(), focal.cuda())
            torch.cuda.synchronize()
        tf_launches[f"f32 forward {label}"] = check_counts(f"TF f32 forward {label}", 1, "taps")
        diffs = []
        for name, g, w in zip(names, got, want, strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4,
                                       msg=lambda m: f"TF {label} {name}: {m}")
            diffs.append((g.cpu() - w).abs().max().item())
        print(f"TF graph {label} f32, card against CPU: max abs diffs {diffs!r} within rtol "
              f"1e-3, atol 1e-4; launches {tf_launches[f'f32 forward {label}']}")
        if dataset == "nyu":
            reset_counts()
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                bf16 = model(x.cuda(), focal.cuda())[4]
                torch.cuda.synchronize()
            tf_launches["bf16 forward nyu 480x640"] = check_counts("TF bf16 forward", 1, "taps")
            diff = (bf16.float().cpu() - got[4].cpu()).abs().max().item()
            if not (torch.isfinite(bf16).all() and diff < 0.15):
                raise RuntimeError(f"TF bf16 forward: max abs diff to f32 {diff} m")
            print(f"TF graph nyu bf16 against f32 on the card: max abs diff {diff!r} m; launches "
                  f"{tf_launches['bf16 forward nyu 480x640']}")
            tf_state = {k: v.cpu() for k, v in model.state_dict().items()}
        del model, got, want
        torch.cuda.empty_cache()

    # (c) cli.test from a TF-graph .pth, flavor and normalization resolved
    # from it.
    tf_tmp = tempfile.TemporaryDirectory()
    tmp = tf_tmp.name
    data = os.path.join(tmp, "data")
    manifest = write_nyu_frames(data, TRAIN_BATCH * TF_TRAIN_STEPS)
    serve_manifest = write_manifest_head(manifest, "serve.txt", EVAL_FRAMES)
    tf_pth = os.path.join(tmp, "tf_graph.pth")
    torch.save({"model": tf_state}, tf_pth)
    capture = io.StringIO()
    os.chdir(tmp)
    try:
        reset_counts()
        with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
            rc = cli_test.main([
                "--encoder", "densenet161_bts", "--dataset", "nyu", "--max_depth", "10",
                "--compute_dtype", "bfloat16", "--eval_batch_size", str(EVAL_BATCH),
                "--data_path", data, "--filenames_file", serve_manifest,
                "--model_name", "tf_graph", "--checkpoint_path", tf_pth,
                "--model_flavor", "auto", "--normalization", "auto"])
        torch.cuda.synchronize()
        tf_launches["cli.test"] = check_counts("TF cli.test", math.ceil(EVAL_FRAMES / EVAL_BATCH),
                                               "taps")
    finally:
        os.chdir(cwd)
    if rc != 0 or "model_flavor tf, normalization caffe" not in capture.getvalue():
        raise RuntimeError(f"TF cli.test: rc {rc}, output {capture.getvalue()[-2000:]!r}")
    check_pngs(os.path.join(tmp, "result_tf_graph", "raw"), EVAL_FRAMES, (480, 640), np.uint16)
    print(f"cli.test from a TF-graph .pth (flavor and normalization auto): resolved tf and "
          f"caffe, {EVAL_FRAMES} raw pngs, launches {tf_launches['cli.test']}")

    # (d) One f32 train step card against CPU, then cli.train on the recipe.
    tf_launches["f32 train step"] = train_step_card_against_cpu(
        torch, Config, create_model, create_optimizer, TrainState, make_train_step,
        reset_counts, counts, flavor="tf")[0]
    log_dir = os.path.join(tmp, "logs")
    args_path, overrides = train_args(manifest, serve_manifest, log_dir)
    overrides += ["--model_flavor", "tf", "--no-do_online_eval", "--save_freq",
                  str(TF_TRAIN_STEPS), "--model_name", "tf_nyu"]
    capture = io.StringIO()
    os.chdir(tmp)
    try:
        reset_counts()
        with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
            rc = cli_train.main(["@" + args_path, *overrides])
        torch.cuda.synchronize()
        tf_train = counts()
    finally:
        os.chdir(cwd)
    steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(capture.getvalue())]
    if rc != 0 or [gs for gs, _ in steps] != list(range(1, TF_TRAIN_STEPS + 1)) or not all(
            math.isfinite(loss) for _, loss in steps):
        raise RuntimeError(f"TF cli.train: rc {rc}, logged {steps}")
    if (tf_train["lpg_backward"] != 3 * TF_TRAIN_STEPS or tf_train["lpg"] < 3 * TF_TRAIN_STEPS
            or tf_train["taps"] or tf_train["eo"]):
        raise RuntimeError(f"TF cli.train: kernel launches {tf_train}, expected 3 LPG backward "
                           "and at least 3 LPG forward a step, no dense")
    tf_launches["cli.train"] = tf_train
    saved = load_checkpoint(os.path.join(log_dir, "tf_nyu", f"model-{TF_TRAIN_STEPS}"))
    stats = [k for k in saved if "running_" in k or k.endswith("num_batches_tracked")]
    moved = [k for k in stats if not torch.equal(
        saved[k], torch.full_like(saved[k], 1.0 if k.endswith("running_var") else 0.0))]
    if "decoder.get_depth.0.bias" not in saved or not stats or moved:
        raise RuntimeError(f"TF cli.train: BN statistics moved: {moved[:5]}")
    print(f"cli.train --model_flavor tf: {TF_TRAIN_STEPS} steps at batch {TRAIN_BATCH} (bf16, "
          f"device_augment), losses {[loss for _, loss in steps]!r}, kernel launches {tf_train}; "
          f"all {len(stats)} BN statistics of model-{TF_TRAIN_STEPS} as seeded")
    tf_tmp.cleanup()

    # (e) bf16 img/s at batch 8, TF graph beside PT graph, in turns.
    graphs = {f: create_model(Config(encoder="densenet161_bts", bts_size=512,
                                     model_flavor=f)).cuda().eval() for f in ("pt", "tf")}
    runs = [(f, forward_rate(torch, graphs[f], 8)) for f in ("pt", "tf", "tf", "pt")]
    tf_rates = {f: statistics.mean(r for g, r in runs if g == f) for f in graphs}
    print(f"forward bf16 480x640 batch 8, PT graph {tf_rates['pt']!r} img/s, TF graph "
          f"{tf_rates['tf']!r} img/s (runs in turn {runs!r}; {smi})")
    del graphs
    torch.cuda.empty_cache()

    # (f) The native CPU LPG on the card's host.
    lpg_cpu_rec = check_lpg_ffi(torch, lpg, lpg_cpu, _build)
    print(f"native CPU LPG (g++ -O3, one thread) on {lpg_cpu_rec['cpu']}: three NYU sites at "
          f"B=1, forward {lpg_cpu_rec['ms']!r} ms against plain {lpg_cpu_rec['plain_ms']!r} ms, "
          f"gradient {lpg_cpu_rec['grad_ms']!r} ms against {lpg_cpu_rec['grad_plain_ms']!r} ms "
          f"(PyTorch on {lpg_cpu_rec['torch_threads']} threads); on a CUDA tensor: "
          f"{lpg_cpu_rec['cuda_refused']!r}")
    print(json.dumps({"tf_forward_bf16_b8_img_per_s": tf_rates, "tf_launches": tf_launches,
                      "lpg_cpu": lpg_cpu_rec, "device": smi}))
    phase()
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))

    if "jax" in sys.modules or "flax" in sys.modules:
        raise RuntimeError("jax was imported")
    bts_tpu = sorted(m for m in sys.modules if m == "bts_tpu" or m.startswith("bts_tpu."))
    if bts_tpu:
        raise RuntimeError(f"the JAX package was imported: {bts_tpu}")
    print(smi)
    # No single PyTorch call computes either function (library_ms null); the
    # dense layers' yardstick is the unfused cuDNN chain, cudnn_chain_ms.
    def lpg_record(key):
        err, ms, plain_ms, bound, unfused = lpg_res[key]
        rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
        return rec if unfused is None else {**rec, "unfused_ms": unfused}

    # Phase 10's paths by the dtype they run the taps kernel in.
    tf_dtype = {"bfloat16": ("bf16", "cli.test"), "float32": ("f32",)}

    def dense_record(impl, name, launches, n_fwd):
        r = dense[impl, name, 8]
        eo = ("layer_bound_ms",) if impl == "eo" else ()
        return {
            "name": f"fused_dense_{impl}_{ {'bfloat16': 'bf16', 'float32': 'f32'}[name]}",
            "route": "cuda", "source": DENSE_SOURCE[impl, name],
            "replaces": DENSE_REPLACES[impl], "launches": launches[impl],
            "launches_per_forward": launches[impl] // n_fwd, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_ms(r["flops"], r["bytes"], name)[1], "library_ms": None,
            "cudnn_chain_ms": r["cudnn_chain_ms"], **{k: r[k] for k in eo},
            "b1": {k: dense[impl, name, 1][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                        "cudnn_chain_ms", "bound_ms", *eo)},
            "densenet121": {f"b{b}": dense121[impl, name, b] for b in (8, 1)},
            **({"tf_launches": {k: v["taps"] for k, v in tf_launches.items()
                                if v["taps"] and k.startswith(tf_dtype[name])}}
               if impl == "taps" else {}),
        }

    print(json.dumps({"kernels": [
        {"name": "lpg_forward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_REPLACES, "out_dtype": "bfloat16", "launches": serving["lpg"],
         "launches_per_forward": serving["lpg"] // forwards, **lpg_record("bfloat16"),
         "bound_by": "bytes", "library_ms": None,
         "float32": lpg_record("float32"), "bare_float32": lpg_record("bare"),
         "train_sites": dict(zip(("ms", "plain_ms", "bound_ms"), lpg_fwd_train)),
         "zoo_launches": {k: v["lpg"] for k, v in zoo_launches.items()},
         "tf_launches": {k: v["lpg"] for k, v in tf_launches.items()}},
        {"name": "lpg_backward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_BWD_REPLACES, "grad_dtype": "bfloat16",
         "launches": train_path["lpg_backward"], "launches_per_step": 3,
         **lpg_bwd["bfloat16"], "bound_by": "bytes", "library_ms": None,
         "launch_floor_ms": floor, "float32": lpg_bwd["float32"],
         "zoo_launches": {k: v["lpg_backward"] for k, v in zoo_launches.items()
                          if v["lpg_backward"]},
         "tf_launches": {k: v["lpg_backward"] for k, v in tf_launches.items()
                         if v["lpg_backward"]}},
        dense_record("taps", "bfloat16", serving, forwards),
        dense_record("taps", "float32", f32_path["taps"], 1),
        dense_record("eo", "bfloat16", eo_path, 1),
        dense_record("eo", "float32", f32_path["eo"], 1),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
