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
4. the port on the card against the port on the CPU in f32: DenseNet161-BTS
   at full width, seeded weights, 1x3x96x128, all 5 outputs at rtol 1e-3,
   atol 1e-4 (cuDNN sums in another order), with ``dense_impl`` auto (taps
   kernel) and eo: exactly 78 launches of that kernel, none of the other,
   and 3 LPG launches per forward;
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
   eo.

The line before the last is the kernels' JSON record (``launches`` from the
serving path of phase 5 for LPG and bf16 taps, from phase 4's f32 forwards
for f32 taps and f32 eo, from the bf16 eo forward of phase 6 for bf16 eo;
``ms``/``plain_ms`` summed over the phase-3 shapes or sites at B=8, in the
record's dtype, the dense kernels' ``b1`` at B=1; eo's ``bound_ms`` counts
its own work, ``layer_bound_ms`` the taps form's); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
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


def densenet161_layer_shapes(h=480, w=640):
    """(grid h, grid w, C) of the first and the last dense layer of each
    DenseNet161 block (growth 48) at an h x w input."""
    shapes, c = [], 96
    for i, n in enumerate((6, 12, 36, 24)):
        s = 4 * 2**i
        shapes += [(h // s, w // s, c), (h // s, w // s, c + (n - 1) * 48)]
        c = (c + n * 48) // 2
    return shapes


def seeded_dense_layer(torch, DenseLayer, c, gen):
    """A DenseNet161 layer on the card: BN statistics drawn around their
    defaults, convs at the init's He scale, from ``gen``."""
    layer = DenseLayer(c, 48)
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
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.encoders.densenet import DenseLayer
    from bts_tpu_torch.ops import _build, fused_dense, fused_dense_cuda, lpg, lpg_cuda

    def reset_counts():
        lpg_cuda.LAUNCHES = fused_dense_cuda.TAPS_LAUNCHES = fused_dense_cuda.EO_LAUNCHES = 0

    def check_counts(what, forwards, dense):
        """The launches since reset_counts(): 78 of the ``dense`` kernel, none
        of the other, 3 LPG, per forward."""
        got = {"taps": fused_dense_cuda.TAPS_LAUNCHES, "eo": fused_dense_cuda.EO_LAUNCHES,
               "lpg": lpg_cuda.LAUNCHES}
        want = {"taps": 0, "eo": 0, "lpg": 3 * forwards}
        want[dense] = DENSE_LAYERS * forwards
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
    for (impl, name, b), r in dense.items():
        layer = (f", layer bound {r['layer_bound_ms']!r} ms "
                 f"({r['layer_bound_ms'] / r['ms']:.2%})" if impl == "eo" else "")
        print(f"dense {impl} {name}, 8 shapes summed at B={b}: kernel {r['ms']!r} ms, plain "
              f"{r['plain_ms']!r} ms, cuDNN chain {r['cudnn_chain_ms']!r} ms, bound "
              f"{r['bound_ms']!r} ms ({r['bound_ms'] / r['ms']:.2%}){layer}, max_abs_err "
              f"{r['max_abs_err']!r}")

    phase("4 port on the card against the port on the CPU, f32")
    cfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=10.0, bts_size=512)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 96, 128, generator=gen)
    focal = torch.tensor([518.8579])
    cpu_model, gpu_model = create_model(cfg).eval(), create_model(cfg).cuda().eval()
    with torch.inference_mode():
        want = cpu_model(x, focal)
    f32_path = {}  # the launches of each f32 forward, by its dense kernel
    for dense_impl, kernel in (("auto", "taps"), ("eo", "eo")):
        gpu_model.encoder.dense_impl = dense_impl
        reset_counts()
        with torch.inference_mode():
            got = gpu_model(x.cuda(), focal.cuda())
            torch.cuda.synchronize()
        f32_path[kernel] = check_counts(f"f32 forward, dense_impl {dense_impl}", 1, kernel)
        for name, g, w in zip(["lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth"], got, want,
                              strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4)
            print(f"dense_impl {dense_impl} {name}: max abs diff GPU vs CPU "
                  f"{(g.cpu() - w).abs().max().item()!r}")
    del cpu_model, gpu_model

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
        }

    print(json.dumps({"kernels": [
        {"name": "lpg_forward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_REPLACES, "out_dtype": "bfloat16", "launches": serving["lpg"],
         "launches_per_forward": serving["lpg"] // forwards, **lpg_record("bfloat16"),
         "bound_by": "bytes", "library_ms": None,
         "float32": lpg_record("float32"), "bare_float32": lpg_record("bare")},
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
