#!/usr/bin/env python3
"""Smoke run of bts_tpu_torch on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure raises and the script exits nonzero:

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``bts_tpu_torch/csrc`` (nvcc);
3. kernel against plain: the LPG kernel against the plain PyTorch version at
   the three NYU 480x640 sites (batch 8) and a ragged case, rtol 1e-6,
   atol 0, with both timed by CUDA events (device time per call);
4. the port on the card against the port on the CPU in f32 (TF32 off):
   DenseNet161-BTS at full width, seeded weights, 1x3x96x128, all 5
   outputs at rtol 1e-3, atol 1e-4 (cuDNN sums in another order);
5. the serving path: ``bts_tpu_torch.cli.test.main`` over 8 synthetic NYU
   480x640 frames in bf16, with the kernels' launch counts reset just
   before; 8 uint16 pngs and exactly 3 LPG launches per forward;
6. bf16 against f32 on one 480x640 batch (max abs diff < 0.15 m), and the
   forward's img/s at batch 1 and 8 in bf16 with the kernel (lpg_impl auto)
   and with the plain LPG (xla).

The line before the last is the kernels' JSON record; the last line is
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


def check_kernel_against_plain(torch, lpg_cuda, lpg):
    """Phase 3. Returns (max abs err, kernel ms, plain ms) summed over the
    three NYU sites at batch 8 (one forward's worth of LPG)."""
    gen = torch.Generator().manual_seed(0)
    cases = [(r, 8, h, w) for r, h, w in NYU_SITES] + [(8, 3, 5, 7)]
    max_err, kernel_ms, plain_ms = 0.0, 0.0, 0.0
    for i, (r, b, h, w) in enumerate(cases):
        logits = torch.randn(b, h, w, 3, generator=gen).cuda()
        pe = lpg.normalize_plane(lpg.decode_plane_eq(logits, 10.0)).contiguous()
        before = lpg_cuda.LAUNCHES
        got = lpg_cuda.lpg_cuda(pe, r)
        torch.cuda.synchronize()
        if lpg_cuda.LAUNCHES != before + 1:
            raise RuntimeError("lpg_cuda did not count its launch")
        want = lpg.lpg_reference(pe, r)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        finite = torch.isfinite(want)
        err = (got - want)[finite].abs().max().item()
        max_err = max(max_err, err)
        k = cuda_median_ms(lambda: lpg_cuda.lpg_cuda(pe, r))
        p = cuda_median_ms(lambda: lpg.lpg_reference(pe, r))
        print(f"lpg r={r} B={b} grid {h}x{w} -> {h * r}x{w * r}: max_abs_err {err!r}, "
              f"kernel {k!r} ms, plain {p!r} ms (median of 50 samples of 10 calls)")
        if i < len(NYU_SITES):
            kernel_ms += k
            plain_ms += p
    return max_err, kernel_ms, plain_ms


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


def throughput(torch, model, batch, impl, iters=20):
    """Forward img/s in bf16 at this batch, CUDA events around iters runs."""
    model.decoder.lpg_impl = impl
    x = torch.randn(batch, 3, 480, 640, device="cuda")
    focal = torch.full((batch,), 518.8579, device="cuda")
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
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
    from bts_tpu_torch.ops import _build, lpg, lpg_cuda

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"built {lib_path} in {time.perf_counter() - t0:.2f} s")

    phase("3 kernel against plain")
    max_err, kernel_ms, plain_ms = check_kernel_against_plain(torch, lpg_cuda, lpg)
    print(f"three NYU sites at B=8: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms")

    phase("4 port on the card against the port on the CPU, f32")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=10.0, bts_size=512)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 96, 128, generator=gen)
    focal = torch.tensor([518.8579])
    with torch.inference_mode():
        want = create_model(cfg).eval()(x, focal)
        before = lpg_cuda.LAUNCHES
        got = create_model(cfg).cuda().eval()(x.cuda(), focal.cuda())
        torch.cuda.synchronize()
    if lpg_cuda.LAUNCHES != before + 3:
        raise RuntimeError(f"expected 3 LPG launches, got {lpg_cuda.LAUNCHES - before}")
    for name, g, w in zip(["lpg8x8", "lpg4x4", "lpg2x2", "reduc1x1", "depth"], got, want,
                          strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4)
        print(f"{name}: max abs diff GPU vs CPU {(g.cpu() - w).abs().max().item()!r}")

    phase("5 serving path: bts_tpu_torch.cli.test.main")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        n_frames, batch = 8, 4
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
            lpg_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli_test.main(argv)
            torch.cuda.synchronize()
            launches = lpg_cuda.LAUNCHES
            elapsed = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError(f"cli.test.main returned {rc}")
        forwards = math.ceil(n_frames / batch)
        if launches != 3 * forwards:
            raise RuntimeError(f"LPG kernel launches {launches}, expected {3 * forwards}")
        raw = os.path.join(tmp, "result_chip_smoke", "raw")
        pngs = sorted(os.listdir(raw))
        if len(pngs) != n_frames:
            raise RuntimeError(f"expected {n_frames} raw pngs, found {pngs}")
        for p in pngs:
            a = np.asarray(Image.open(os.path.join(raw, p)))
            if a.dtype != np.uint16 or a.shape != (480, 640) or a.max() == 0:
                raise RuntimeError(f"{p}: {a.dtype} {a.shape} max {a.max()}")
    print(f"{n_frames} raw pngs, {forwards} forwards, {launches} LPG kernel launches, "
          f"{elapsed:.1f} s including model build")

    phase("6 bf16 against f32, throughput")
    model = create_model(cfg).cuda().eval()
    x = torch.randn(4, 3, 480, 640, generator=gen).cuda()
    focal = torch.full((4,), 518.8579, device="cuda")
    with torch.inference_mode():
        f32 = model(x, focal)[4]
        with torch.autocast("cuda", dtype=torch.bfloat16):
            bf16 = model(x, focal)[4]
    if not (torch.isfinite(f32).all() and torch.isfinite(bf16).all()):
        raise RuntimeError("non-finite depth")
    if tuple(bf16.shape) != (4, 1, 480, 640):
        raise RuntimeError(f"depth shape {tuple(bf16.shape)}")
    diff = (bf16 - f32).abs().max().item()
    print(f"bf16 vs f32 final depth, 4x480x640: max abs diff {diff!r} m")
    if diff >= 0.15:
        raise RuntimeError(f"bf16 vs f32 max abs diff {diff} m >= 0.15 m")
    rates = {}
    for b in (1, 8):
        # In turns (plain, kernel, kernel, plain), averaged per impl.
        runs = [(impl, throughput(torch, model, b, impl)) for impl in ("xla", "auto", "auto", "xla")]
        print(f"batch {b} runs in turn: {runs!r}")
        for impl in ("auto", "xla"):
            rates[f"b{b}_{impl}"] = statistics.mean(r for i, r in runs if i == impl)
        print(f"forward bf16 480x640 batch {b}: lpg auto (kernel) {rates[f'b{b}_auto']!r} img/s, "
              f"lpg xla (plain) {rates[f'b{b}_xla']!r} img/s ({smi})")

    if "jax" in sys.modules or "flax" in sys.modules:
        raise RuntimeError("jax was imported")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "lpg_forward_f32", "route": "cuda", "source": LPG_SOURCE,
        "replaces": LPG_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
