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
       beside the plain version and its bound; the LPG forward timed at the
       same sites;
   (b) one f32 train step (TF32 off) of DenseNet161-BTS at full width on a
       2x416x544 batch, card against CPU: the loss at rtol 1e-4, every
       parameter and BN statistic at atol 1e-4; exactly 3 LPG forward and 3
       LPG backward launches and no fused dense launch;
   (c) the slice's main path: ``bts_tpu_torch.cli.train.main`` with
       ``configs/arguments_train_nyu.txt`` minus its online-eval lines
       (DenseNet161-BTS, 416x544, batch 4, bf16, ``--device_augment``,
       host rotation) over 24 synthetic NYU 480x640 frames for 6 steps, the
       counts reset just before: finite logged losses, 3 LPG backward
       launches a step, a ``model-5`` checkpoint, and ``cli.test`` serving
       pngs from it;
   (d) the train step's img/s in bf16 at batch 4 and 16 (or the largest of
       12 and 8 that fits) and in f32 at batch 4, after 3 warm-up steps.

The line before the last is the kernels' JSON record (``launches`` from the
serving path of phase 5 for LPG and bf16 taps, from phase 4's f32 forwards
for f32 taps and f32 eo, from the bf16 eo forward of phase 6 for bf16 eo,
from phase 7's ``cli.train`` for the LPG backward;
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
# The args file's online-eval lines (queue 1, item 11 ports online eval).
ONLINE_EVAL_FLAGS = ("--do_online_eval", "--eval_freq", "--data_path_eval", "--gt_path_eval",
                     "--filenames_file_eval", "--min_depth_eval", "--max_depth_eval",
                     "--eigen_crop")
DENSE_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=1e-4, atol=1e-4)}
# One H100 SXM's published peaks (dense): bf16 tensor cores; f32-accurate
# products as 3xTF32 on the tensor cores, three TF32 products (494.7 TFLOP/s)
# for each f32 one (with FMAs outside the tensor cores f32 peaks at 67
# TFLOP/s); and HBM3. The bounds below divide this run's work by them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
HBM_BYTES_PER_S = 3.35e12


def phase(msg):
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


def check_lpg_train(torch, lpg_cuda, lpg):
    """Phase 7a: the LPG backward kernel against ``lpg_backward_scaled`` at
    the three train sites (batch 4) with f32 and bf16 incoming gradients, and
    ragged cases at r = 2, 4 and 8 with a strided gradient (a channel of a
    wider map); then each train site timed (backward kernel and plain, and
    the forward kernel with bf16 out and its plain version). Returns
    ({grad dtype name: [max abs err, ms, plain ms, bound ms]}, forward
    [ms, plain ms, bound ms]), summed over the three sites."""
    gen = torch.Generator().manual_seed(6)
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
            bound = lpg_backward_bound(b, h, w, r, dt.itemsize)[0]
            print(f"lpg backward {where}: max abs err {err.max().item()!r} (largest error / "
                  f"terms' magnitude {share!r}), kernel {k!r} ms, plain {p!r} ms (median of 50 "
                  f"samples of 10 calls); bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of it")
            acc = bwd.setdefault(name, [0.0, 0.0, 0.0, 0.0])
            bwd[name] = [max(acc[0], err.max().item()), acc[1] + k, acc[2] + p, acc[3] + bound]
        if i < len(TRAIN_SITES):
            k = cuda_median_ms(lambda: lpg_cuda.lpg_cuda(pe, r, MAX_DEPTH, torch.bfloat16))
            p = cuda_median_ms(lambda: lpg.lpg_scaled_reference(pe, r, MAX_DEPTH, torch.bfloat16))
            bound = lpg_bound(b, h, w, r, 2)[0]
            print(f"lpg forward train site r={r} B={b} grid {h}x{w}, bf16 out: kernel {k!r} ms, "
                  f"plain {p!r} ms; bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of it")
            fwd = [fwd[0] + k, fwd[1] + p, fwd[2] + bound]
    return bwd, fwd


def train_step_card_against_cpu(torch, Config, create_model, create_optimizer, TrainState,
                                make_train_step, reset_counts, counts):
    """Phase 7b: one f32 train step (TF32 off) of DenseNet161-BTS at full
    width, seeded weights, on a 2x416x544 batch, on the card and on the CPU:
    the loss at rtol 1e-4, every parameter and BN statistic after the step
    at atol 1e-4 (Adam normalises the update: a parameter moves by at most
    about lr = 1e-4); exactly 3 forward and 3 backward LPG launches and no
    fused dense launch on the card."""
    tcfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=2,
                  input_height=416, input_width=544)
    gen = torch.Generator().manual_seed(7)
    host = {"image": torch.randn(2, 416, 544, 3, generator=gen),
            "depth": torch.rand(2, 416, 544, 1, generator=gen) * 9.5 + 0.05,
            "focal": torch.full((2,), 518.8579)}
    out = {}
    for device in ("cuda", "cpu"):
        model = create_model(tcfg).to(device)
        optimizer, _ = create_optimizer(tcfg, model, 1000)
        state = TrainState(model, optimizer)
        reset_counts()
        loss = make_train_step(tcfg)(state, {k: v.to(device) for k, v in host.items()})
        if device == "cuda":
            torch.cuda.synchronize()
            launched = counts()
            want = {"taps": 0, "eo": 0, "lpg": 3, "lpg_backward": 3}
            if launched != want:
                raise RuntimeError(f"f32 train step: kernel launches {launched}, expected {want}")
        out[device] = (loss.cpu(), {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (gl, gs), (cl, cs) = out["cuda"], out["cpu"]
    torch.testing.assert_close(gl, cl, rtol=1e-4, atol=0)
    worst = (0.0, "")
    for key, want in cs.items():
        if not want.is_floating_point():
            torch.testing.assert_close(gs[key], want, rtol=0, atol=0)
            continue
        torch.testing.assert_close(gs[key], want, rtol=0, atol=1e-4, msg=lambda m: f"{key}: {m}")
        worst = max(worst, ((gs[key] - want).abs().max().item(), key))
    print(f"f32 train step, card against CPU: loss {gl.item()!r} against {cl.item()!r}; "
          f"{len(cs)} state entries within atol 1e-4, largest diff {worst[0]!r} ({worst[1]}); "
          f"launches {launched}")
    return launched


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


def train_args(root, manifest, log_dir):
    """``configs/arguments_train_nyu.txt`` minus its online-eval lines, with
    this run's data, one epoch, a save within the run and a log every 3
    steps: (path of the args file written under ``root``, overrides)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "arguments_train_nyu.txt")) as f:
        lines = [ln for ln in f if ln.split() and ln.split()[0] not in ONLINE_EVAL_FLAGS]
    path = os.path.join(root, "arguments_train_nyu.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    data = os.path.dirname(manifest)
    return path, ["--data_path", data, "--gt_path", data, "--filenames_file", manifest,
                  "--log_directory", log_dir, "--num_epochs", "1", "--save_freq", "5",
                  "--log_freq", "3"]


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
    """Forward img/s at this batch, in bf16 autocast (or f32), CUDA events
    around iters runs."""
    model.encoder.dense_impl = dense_impl
    model.decoder.lpg_impl = lpg_impl
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

    from bts_tpu_torch.cli import test as cli_test
    from bts_tpu_torch.cli import train as cli_train
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.encoders.densenet import DenseLayer
    from bts_tpu_torch.ops import _build, fused_dense, fused_dense_cuda, lpg, lpg_cuda
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
    for name, (err, k, p, bound) in lpg_bwd.items():
        print(f"lpg backward, grad {name}, three train sites at B={TRAIN_BATCH}: kernel {k!r} ms, "
              f"plain {p!r} ms, bound {bound!r} ms by bytes ({bound / k:.2%}), max_abs_err {err!r}")
    print(f"lpg forward, bf16 out, three train sites at B={TRAIN_BATCH}: kernel "
          f"{lpg_fwd_train[0]!r} ms, plain {lpg_fwd_train[1]!r} ms, bound {lpg_fwd_train[2]!r} ms")
    train_step_card_against_cpu(torch, Config, create_model, create_optimizer, TrainState,
                                make_train_step, reset_counts, counts)

    # The slice's main path: bts_tpu_torch.cli.train.main at full width, then
    # cli.test serving from the checkpoint it wrote.
    train_steps = 6
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_nyu_frames(os.path.join(tmp, "data"), TRAIN_BATCH * train_steps)
        log_dir = os.path.join(tmp, "logs")
        args_path, overrides = train_args(tmp, manifest, log_dir)
        capture = io.StringIO()
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
                rc = cli_train.main(["@" + args_path, *overrides])
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            train_path = counts()
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"cli.train.main returned {rc}")
        steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(capture.getvalue())]
        if [gs for gs, _ in steps] != list(range(1, train_steps + 1)):
            raise RuntimeError(f"cli.train logged steps {steps}, expected 1..{train_steps}")
        if not all(math.isfinite(loss) for _, loss in steps):
            raise RuntimeError(f"cli.train logged a non-finite loss: {steps}")
        if train_path["lpg_backward"] != 3 * train_steps or train_path["lpg"] < 3 * train_steps:
            raise RuntimeError(f"cli.train: kernel launches {train_path}, expected 3 LPG "
                               f"backward and at least 3 LPG forward launches a step")
        run_dir = os.path.join(log_dir, "bts_nyu_v2_tpu")
        ckpt = os.path.join(run_dir, "model-5")
        if not os.path.isfile(ckpt):
            raise RuntimeError(f"cli.train wrote no {ckpt}: {sorted(os.listdir(run_dir))}")
        print(f"cli.train: {train_steps} steps at batch {TRAIN_BATCH} (bf16, device_augment), "
              f"losses {[loss for _, loss in steps]!r}, kernel launches {train_path}, "
              f"{elapsed:.1f} s including model build; wrote {sorted(os.listdir(run_dir))}")
        with open(manifest) as f:
            frames = f.readlines()[:TRAIN_BATCH]
        test_manifest = os.path.join(tmp, "data", "test.txt")
        with open(test_manifest, "w") as f:
            f.writelines(frames)
        os.chdir(tmp)
        try:
            rc = cli_test.main([
                "--encoder", "densenet161_bts", "--dataset", "nyu", "--max_depth", "10",
                "--compute_dtype", "bfloat16", "--eval_batch_size", str(TRAIN_BATCH),
                "--data_path", os.path.join(tmp, "data"), "--filenames_file", test_manifest,
                "--model_name", "chip_smoke_trained", "--checkpoint_path", ckpt])
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
        if len(pngs) != len(frames):
            raise RuntimeError(f"cli.test from {ckpt}: {pngs}")
        print(f"cli.test served {len(pngs)} uint16 480x640 pngs from {os.path.basename(ckpt)}")

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
        }

    print(json.dumps({"kernels": [
        {"name": "lpg_forward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_REPLACES, "out_dtype": "bfloat16", "launches": serving["lpg"],
         "launches_per_forward": serving["lpg"] // forwards, **lpg_record("bfloat16"),
         "bound_by": "bytes", "library_ms": None,
         "float32": lpg_record("float32"), "bare_float32": lpg_record("bare"),
         "train_sites": dict(zip(("ms", "plain_ms", "bound_ms"), lpg_fwd_train))},
        {"name": "lpg_backward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_BWD_REPLACES, "grad_dtype": "bfloat16",
         "launches": train_path["lpg_backward"], "launches_per_step": 3,
         **dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms"), lpg_bwd["bfloat16"])),
         "bound_by": "bytes", "library_ms": None,
         "float32": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms"), lpg_bwd["float32"]))},
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
