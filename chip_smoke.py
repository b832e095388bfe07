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
   forward (the first forward runs eager and counts its launches where the
   kernels' wrappers launch them; the second is a capture and a replay of
   the forward's CUDA graph, whose launches are the capture's tally, added
   by ``models/graphed.py``; phase 15 holds such replays to the eager
   forward bit for bit);
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
       named from /proc/cpuinfo; ``impl="ffi"`` on a CUDA tensor raises;
11. data parallelism (``bts_tpu_torch/parallel``; the script needs one card
    and NCCL refuses two ranks on one device, so two ranks share ``cuda:0``
    over gloo, which stages CUDA tensors through the host; each rank counts
    its own launches and reports them):
   (a) DenseNet161-BTS on the NYU recipe at full width (416x544 crops of
       427x565 frames, ``--device_augment``), a global batch of 4, 2 a
       rank: one f32 step (TF32 off) on each rank against the single-process
       step on the card on the whole batch (``DP_TOL``: loss rtol 1e-4,
       every parameter and BN statistic atol 1e-4; the two ranks' states
       equal), then two bf16 steps with finite losses; 3 LPG forward and 3
       LPG backward launches a rank a step;
   (b) one rank over NCCL (this process, its group left after): its DDP
       step against the plain step on the same batch of 2, deterministic
       cuDNN (loss rtol 1e-5, state atol 1e-5);
   (c) ``cli.train.main`` with ``--num_devices 2 --device cuda:0,cuda:0
       --dist_backend gloo`` on the recipe for 4 steps, an online eval every
       2 steps over 8 synthetic 480x640 frames at batch 1 (4 a rank): finite
       losses each logged once, each eval over 8, one run dir, a best
       checkpoint per metric with no DDP ``module.`` names, and a fresh
       single-process model on each giving the measure the checkpoint's best
       tracker logged (rtol 1e-5);
   (d) ``make_sharded_forward`` on ``[cuda:0, cuda:0]``, DenseNet161-BTS at
       480x640, batch 8: f32 within 1e-4 m and bf16 within 0.15 m of the
       single f32 forward, 78 taps and 3 LPG launches a replica;
   (e) the two ranks' step wall ms beside the single process's (a check:
       gloo stages gradients through the host);
   (f) (a)'s f32 step on the two gloo ranks for ResNet-50-BTS (its
       trainable ``downsample.1`` BNs through the global BN) and the TF-graph
       DenseNet161-BTS (every BN frozen: only the gradients communicate),
       each against one process's step at ``DP_TOL``, the ranks' states
       equal, 3 + 3 LPG launches a rank;
12. a run resumed on the card, and ``--async_checkpoint``:
   (a) DenseNet161-BTS at full width, f32 (TF32 off), deterministic cuDNN,
       2x416x544 batches as in 7(b): 2 steps, a synchronous and an
       asynchronous save of that state (the two files equal tensor for
       tensor), then for each a fresh model and optimizer through
       ``restore_training_start`` and 2 more steps, bit for bit against 4
       uninterrupted steps (every parameter, BN statistic and moment, both
       counts of each group), the counts reset just before the resumed
       steps: 3 LPG forward and 3 LPG backward launches a step;
   (b) the checkpoint's bytes and what a save holds the loop for (host
       clock from the save's call to the end of the next step, less a
       plain step), synchronous and asynchronous, the first save of a
       writer (pinned buffers allocated) and a later one, beside the card's
       name and power limit: a record, not a claim;
   (c) ``cli.train`` on ``configs/arguments_train_nyu.txt`` with
       ``--no-do_online_eval --save_freq 1 --max_to_keep 2
       --async_checkpoint`` for 4 steps: finite losses, 3 LPG backward
       launches a step, exactly ``model-3`` and ``model-4`` left, each
       loading with its step;
13. the benchmark tools (``bts_tpu_torch/tools/bench*.py``, the port's
    ``bench.py`` and ``scripts/bench_{train,zoo,lpg}.py``) through their
    ``main``, under PyTorch's default cuDNN and matmul settings, each line
    printed after the card's, each run's counts reset just before it and
    read just after:
   (a) ``bench`` at its defaults (DenseNet161-BTS NYU 480x640, batch 128,
       bf16): 78 taps and 3 LPG launches a forward over its 2 warm-up and 16
       timed forwards, every sum read back finite;
   (b) ``bench --lpg-check`` (batch 64): the kernels' form against the plain
       one (``lpg_impl xla``, ``dense_impl plain``), its maps within 0.15 m;
       launches from the kernels' form only;
   (c) ``bench_train`` at its defaults (batch 16, 416x544 from 480x640,
       bf16, ``--device_augment``): 3 LPG forward and 3 LPG backward
       launches a step, finite losses;
   (d) ``bench_zoo`` at batch 128 with ``--iters 6 --delay 2``, one call an
       encoder of its seven: 3 LPG launches a forward, and 58 (DenseNet121)
       or 78 (DenseNet161) taps;
   (e) ``bench_lpg`` at its defaults: each chain captured as a CUDA graph
       and timed by its replays, every row so timed (the counts are the
       captured wrapper calls: 6 x 2 x 580 LPG, 6 x 580 LPG backward);
   (f) the kernels against their plain versions at these runs' shapes:
       ``bench``'s batch-128 forward in the kernels' form against the plain
       form on the same image and weights (within 0.15 m), the taps wrapper
       on the first and last dense layer of each block at batch 128, on the
       block buffers' strided views that forward filled (DENSE_TOL), the LPG
       forward bit for bit and its backward within LPG_BWD_TOL on
       ``bench_lpg``'s B=16 planes and at ``bench_train``'s batch-16 sites,
       and the LPG forward at ``bench``'s batch-128 sites;
14. rematerialisation (``--remat``, ``--remat_policy``, ``--remat_scope``;
    ``models/remat.py``), each setting's model from ``create_model``, each
    path's counts reset just before it and read just after:
   (b) one f32 step (TF32 off, deterministic cuDNN) on 7(b)'s 2x416x544
       batch for each setting (conv/encoder, full/encoder, conv/all,
       full/all) against the step without remat from the same seeded state:
       bit-equal or not, and held to ``REMAT_TOL`` (loss rtol 1e-4, every
       parameter and BN statistic atol 1e-4, every ``num_batches_tracked``
       equal);
   (a) ``bench_train``'s bf16 step (416x544 from 480x640, its Config and
       host batches) at batches 8 and 16 for no remat and the four
       settings: ``max_memory_allocated`` over 3 steps after a warm-up,
       wall ms a step, and the launches: 3 LPG backward a step, 3 LPG
       forward, 6 under scope ``all`` (the decoder's recompute calls the
       kernel again); the bytes an image as the slope between the batches;
   (c) the smallest multiple of 16 at which the step without remat,
       extrapolated, exceeds the card's memory: one step there under
       conv/all (its own extrapolation must fit) and conv/encoder if its
       extrapolation fits, each peak printed; no step without remat there;
       then a ``cli.test`` forward (``apps/predict.py``) of a model built
       with ``--remat --remat_scope all``: 78 taps and 3 LPG launches;
   (d) two gloo ranks sharing the card (11(a)'s harness and batch) take one
       f32 step with conv/all against one process, deterministic cuDNN,
       at ``DP_TOL``, the ranks' states equal, the global BN's buffers'
       largest difference printed; the ranks start first and run beside
       (b), which times nothing;
15. the graphed inference forward (``models/graphed.py``; PyTorch's default
    cuDNN and matmul settings): DenseNet161-BTS NYU 480x640 at batch 8 and
    1 and ResNeXt-101-BTS KITTI 352x1216 at batch 8, in bf16 autocast and
    in f32, and DenseNet161 NYU batch 8 with ``dense_impl`` ``eo`` and in
    the TF graph, in bf16, seeded: the third call of a call key (a replay)
    bit for bit against the eager forward (``model._forward``) on the same
    weights and input, its launches equal to the eager forward's (78 taps,
    0 for ResNeXt, 78 eo for ``eo``, and 3 LPG); the next call on another
    input bit for bit against its eager forward, and the replay's outputs
    unchanged by it; one eager call, one capture and three replays counted;
    ``load_state_dict`` with another seed's weights drops the graphs at
    once, and the replay captured again is bit for bit the eager forward on
    them; a weight changed in place makes the call drop the stale replay's
    outputs and return the eager forward's; the host ms (until the call
    returns) and wall ms of an eager and a replayed call, with the card's
    name and power limit;
16. NeWCRFs (``--encoder large07``): the window-attention kernel
    (``ops/window_attention.py``, Triton, on the token grid) against its
    plain version at each of the 8 call shapes of a batch-8 480x640
    forward, bf16 and f32, shifted and not, with random non-zero pad rows
    (``WINDOW_ATTN_TOL``), its device ms beside its bound, the plain
    version's and SDPA's (``library_ms``); the published model, seeded,
    every bias at 0.1 * randn, at NYU 480x640 batch 8 in bf16 against the
    float32 reference (``tests/newcrfs_reference.py``, TF32 off); the
    graph's replay bit for bit against the eager forward with 32 launches,
    the graphs dropped on ``load_state_dict``; the eager and the replayed
    forward profiled (``tools/profile_forward.py``): 32 window-attention
    launches and no roll kernel; the forward's peak memory; ``cli.test
    --encoder large07`` over 8 frames (``--save_lpg`` refused); the
    LayerNorm kernel (``ops/layer_norm.py``, Triton) against its plain
    version at the forward's norm shapes, bf16 and f32 in and out
    (``LAYER_NORM_TOL``), its device ms beside its byte bound, the plain
    version's and ``F.layer_norm``'s, and the forward's 76 calls summed;
    every norm's weight drawn off identity beside the biases; 76 LayerNorm
    launches and no ``vectorized_layer_norm_kernel`` a forward.
17. Depth Anything V2 (``--encoder dav2_vitl``): the global-attention
    kernel (``ops/global_attention.py``, Triton, read from ``qkv``'s
    output) against its plain version at the KITTI cell's call (8, 16,
    4737, 64) and at N = 64, 65, 128 and 1815, bf16 (within one bf16 ulp of
    the output's largest magnitude) and f32 (1e-5); its device ms beside its
    bound, the plain version's and SDPA's flash and cuDNN backends
    (``library_ms``, yardsticks the port never calls), and other tile
    settings; the published model, seeded, biases, norms and LayerScale
    drawn off their defaults, at KITTI 352x1216 batch 8 in bf16 and in f32
    against the float32 reference (``tests/depth_anything_reference.py``,
    TF32 off; ``DAV2_GATES``); the
    replay bit for bit against the eager forward with 24 global-attention
    and 52 LayerNorm launches; eager and replay ms, peak memory; the eager
    and the replayed forward profiled at 352x1216 with the device ms inside
    the spans ``dav2/encoder`` and ``dav2/head``, and by
    ``tools/profile_forward.py --encoder dav2_vitl``; ``cli.test --encoder
    dav2_vitl --dataset kitti --max_depth 80`` over 8 KITTI frames after
    ``kb_crop``; the cell's check (``benchmark/``) of the program and of each
    planted fault of ``tests/test_torch_depth_anything.py`` at the cell's
    size, against its limits.
Each phase's seconds are printed as it ends, and as JSON after phase 17.

The line before the last is the kernels' JSON record (``launches`` from the
serving path of phase 5 for LPG and bf16 taps (a replayed forward's from
its capture's tally), from phase 4's f32 forwards
for f32 taps and f32 eo, from the bf16 eo forward of phase 6 for bf16 eo,
from phase 7's ``cli.train`` for the LPG backward, with its per-site times
and the launch floor; both LPG records carry phase 9's counts by path, and
they and the taps records phase 10's under ``tf_launches`` and phase 11's
under ``dp_launches``; both LPG records phase 12's under
``resume_launches``; both LPG records and the bf16 taps record phase 13's
under ``bench_launches``; both LPG records phase 14's under ``remat_launches``;
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
    g = grad.float() if max_depth is None else grad.float() / max_depth
    den, n4, u = lpg._den(pe, r)
    inv = 1.0 / den
    gt = g.reshape(b, h, r, w, r)
    c = (gt * n4 * inv * inv).abs()
    return torch.stack([(c * u.abs()).sum((2, 4)), (c * u.abs()[:, None, None]).sum((2, 4)),
                        c.sum((2, 4)), (gt * inv).abs().sum((2, 4))], dim=-1)


def lpg_backward_against_plain(torch, lpg_cuda, lpg, pe, grad, r, max_depth, where):
    """One ``lpg_backward_cuda`` launch against ``lpg_backward_scaled``, each
    component within LPG_BWD_TOL of the sum of its terms' magnitudes. Returns
    (max abs err, largest error / terms' magnitude)."""
    before = lpg_cuda.BWD_LAUNCHES
    got = lpg_cuda.lpg_backward_cuda(pe, grad, r, max_depth)
    torch.cuda.synchronize()
    if lpg_cuda.BWD_LAUNCHES != before + 1:
        raise RuntimeError("lpg_backward_cuda did not count its launch")
    want = lpg.lpg_backward_scaled(pe, grad, r, max_depth)
    scale = lpg_backward_magnitudes(torch, lpg, pe, grad, r, max_depth)
    err = (got - want).abs()
    limit = LPG_BWD_TOL["atol"] + LPG_BWD_TOL["rtol"] * scale
    if not bool((err <= limit).all()):
        worst = (err / limit).max().item()
        raise RuntimeError(f"lpg backward {where}: error {worst!r} x its limit "
                           f"(max abs err {err.max().item()!r})")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


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
            where = f"r={r} B={b} grid {h}x{w} grad {name}{' strided' if strided else ''}"
            err, share = lpg_backward_against_plain(torch, lpg_cuda, lpg, pe, grad, r, MAX_DEPTH,
                                                    where)
            if i >= len(TRAIN_SITES):
                print(f"lpg backward {where}: within tolerance, max abs err {err!r}, "
                      f"largest error / terms' magnitude {share!r}")
                continue
            k = cuda_median_ms(lambda: lpg_cuda.lpg_backward_cuda(pe, grad, r, MAX_DEPTH))
            p = cuda_median_ms(lambda: lpg.lpg_backward_scaled(pe, grad, r, MAX_DEPTH))
            # As autograd launches it: right after another PyTorch kernel.
            a = cuda_median_ms(lambda: (one.add_(1),
                                        lpg_cuda.lpg_backward_cuda(pe, grad, r, MAX_DEPTH)))
            bound = lpg_backward_bound(b, h, w, r, dt.itemsize)[0]
            print(f"lpg backward {where}: max abs err {err!r} (largest error / "
                  f"terms' magnitude {share!r}), kernel {k!r} ms, plain {p!r} ms (median of 50 "
                  f"samples of 10 calls); bound {bound * 1e3!r} us by bytes, {bound / k:.2%} of "
                  f"it; a one-element add then the kernel {a!r} ms")
            acc = bwd.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "sites": []})
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
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


# Phase 11: data parallelism. Two ranks share the one card over gloo (NCCL
# refuses two ranks on one device); one rank runs over NCCL.
DP_RANKS = 2
DP_BATCH = 4  # the recipe's global batch: 2 a rank
DP_TOL = dict(rtol=1e-4, atol=1e-4)  # phase 7(b)'s: loss rtol, state atol
DP_NCCL_ATOL = 1e-5
DP_EVAL_FREQ, DP_STEPS = 2, 4
DP_SERVE_BATCH = 8


def dp_expected_launches(steps=0, forwards=0, replicas=1, layers=DENSE_LAYERS):
    """The kernel launches of one rank's ``steps`` train steps (3 LPG forward
    and 3 LPG backward each, no fused dense layer) and of ``forwards``
    inference forwards on each of ``replicas`` replicas (``layers`` taps and
    3 LPG each)."""
    return {"taps": layers * forwards * replicas, "eo": 0,
            "lpg": 3 * (steps + forwards * replicas), "lpg_backward": 3 * steps}


def kernel_counts():
    """The port's launch counters in this process."""
    from bts_tpu_torch.ops import fused_dense_cuda, lpg_cuda

    return {"taps": fused_dense_cuda.TAPS_LAUNCHES, "eo": fused_dense_cuda.EO_LAUNCHES,
            "lpg": lpg_cuda.LAUNCHES, "lpg_backward": lpg_cuda.BWD_LAUNCHES}


def reset_kernel_counts():
    from bts_tpu_torch.ops import fused_dense_cuda, lpg_cuda

    lpg_cuda.LAUNCHES = lpg_cuda.BWD_LAUNCHES = 0
    fused_dense_cuda.TAPS_LAUNCHES = fused_dense_cuda.EO_LAUNCHES = 0


def state_digest(state):
    """One sha256 over every tensor of a state dict, in key order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_diff(got, want):
    """(largest abs difference, its key) over the floating entries; the
    others must be equal."""
    worst = (0.0, "")
    for k, w in want.items():
        g, w = got[k].detach().cpu(), w.detach().cpu()
        if not w.is_floating_point():
            if not bool((g == w).all()):
                raise RuntimeError(f"{k}: {g.tolist()} != {w.tolist()}")
            continue
        worst = max(worst, (float((g.double() - w.double()).abs().max()), k))
    return worst


def dp_train_rank(path, cfg, dp):
    """Phase 11(a) and (b), one rank: the parent's inputs (``path``) hold the
    seeded state, the global batch and what to run. An f32 step (TF32 off)
    through ``make_train_step(cfg, dp)`` on the rank's share; its loss, its
    state's largest difference from the parent's single-process step and a
    digest of it; the launches. Then (a) two bf16 steps of a fresh copy, the
    second timed, or (b) the plain step (no ``dp``) from the same state on
    the same batch, deterministic cuDNN in both."""
    import torch

    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.parallel.mesh import local_slice
    from bts_tpu_torch.training.optim import create_optimizer
    from bts_tpu_torch.training.state import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(path, weights_only=False)
    torch.backends.cudnn.deterministic = inputs["deterministic"]
    local = {k: v.to(dp.device) for k, v in
             local_slice(inputs["batch"], dp.world, dp.rank).items()}

    def fresh(c):
        model = create_model(c).to(dp.device)
        model.load_state_dict(inputs["state"], strict=True)
        optimizer, _ = create_optimizer(c, model, 1000)
        return TrainState(model, optimizer)

    def timed_step(step, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(st, local))  # the readback waits for the step
        return loss, (time.perf_counter() - t0) * 1e3

    out = {}
    st = fresh(cfg)
    reset_kernel_counts()
    loss, ms = timed_step(make_train_step(cfg, dp), st)
    after = st.model.state_dict()
    out["f32"] = {"loss": loss, "ms": ms, "launches": kernel_counts(),
                  "diff": state_diff(after, inputs["want"]) if inputs["want"] else None,
                  "digest": state_digest(after)}
    del st
    if inputs["plain"]:
        st = fresh(cfg)
        loss, ms = timed_step(make_train_step(cfg), st)
        out["plain"] = {"loss": loss, "ms": ms, "diff": state_diff(st.model.state_dict(), after)}
        del st
    else:
        bcfg = cfg.replace(compute_dtype="bfloat16")
        st = fresh(bcfg)
        step = make_train_step(bcfg, dp)
        reset_kernel_counts()
        runs = [timed_step(step, st) for _ in range(2)]
        out["bf16"] = {"losses": [r[0] for r in runs], "ms": runs[1][1],
                       "launches": kernel_counts()}
    return out


def dp_f32_rank(path, cfg, dp):
    """Phase 11(f), one rank: for each graph of the parent's inputs
    (``path``: its config, seeded state and single-process state after the
    step), one f32 step (TF32 off, deterministic cuDNN, so that the result
    repeats from call to call) through ``make_train_step(cfg, dp)`` on the
    rank's share of the global batch: its loss, its state's largest
    difference from the single-process step's (and its BN buffers'), a
    digest and the launches."""
    import torch

    from bts_tpu_torch.models import create_model
    from bts_tpu_torch.parallel.mesh import local_slice
    from bts_tpu_torch.training.optim import create_optimizer
    from bts_tpu_torch.training.state import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    inputs = torch.load(path, weights_only=False)
    local = {k: v.to(dp.device) for k, v in
             local_slice(inputs["batch"], dp.world, dp.rank).items()}
    out = {}
    for name, run in inputs["runs"].items():
        model = create_model(run["cfg"]).to(dp.device)
        model.load_state_dict(run["state"], strict=True)
        optimizer, _ = create_optimizer(run["cfg"], model, 1000)
        st = TrainState(model, optimizer)
        reset_kernel_counts()
        loss = float(make_train_step(run["cfg"], dp)(st, local))
        after = model.state_dict()
        bn = [k for k in after if "running_" in k or k.endswith("num_batches_tracked")]
        out[name] = {"loss": loss, "launches": kernel_counts(),
                     "diff": state_diff(after, run["want"]), "digest": state_digest(after),
                     "bn_diff": state_diff({k: after[k] for k in bn},
                                           {k: run["want"][k] for k in bn})}
        del model, optimizer, st
    return out


@contextlib.contextmanager
def captured_fd_stdout(into):
    """Send file descriptor 1 (this process's and its children's output) to a
    file while the block runs; then echo it, and append it to ``into``."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            text = f.read().decode(errors="replace")
            sys.stdout.write(text)
            into.append(text)


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


def phase11(torch, Config, parse_args, create_model, create_optimizer, TrainState,
            make_train_step, cli_train, run_online_eval, load_checkpoint, list_step_checkpoints,
            smi):
    """Phase 11, data parallelism (``bts_tpu_torch/parallel``). Returns the
    kernel launches of each data-parallel path, by path."""
    import functools

    from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, NUM_LOWER_BETTER
    from bts_tpu_torch.parallel import launch, mesh
    from bts_tpu_torch.parallel.inference import make_sharded_forward
    from bts_tpu_torch.training.checkpoint import BestTracker, load_checkpoint_dict

    launches, info = {}, {}
    tcfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=DP_BATCH,
                  input_height=416, input_width=544, device_augment=True)
    gen = torch.Generator().manual_seed(11)
    host = {"image": torch.rand(DP_BATCH, 427, 565, 3, generator=gen),
            "depth": torch.rand(DP_BATCH, 427, 565, 1, generator=gen) * 9.5 + 0.05,
            "focal": torch.full((DP_BATCH,), 518.8579)}
    seeded = create_model(tcfg).state_dict()

    def single_steps(cfg, n, state=seeded):
        """n single-process steps on the global batch from ``state``: (last
        loss, its wall ms, the state after)."""
        model = create_model(cfg).cuda()
        model.load_state_dict(state, strict=True)
        optimizer, _ = create_optimizer(cfg, model, 1000)
        st, step = TrainState(model, optimizer), make_train_step(cfg)
        dev = {k: v.cuda() for k, v in host.items()}
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(st, dev))
            ms = (time.perf_counter() - t0) * 1e3
        return loss, ms, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    # (a) Two gloo ranks on cuda:0, 2 samples each, against one process on
    # the global batch of 4: one f32 step (TF32 off, as phase 3 set it).
    single_loss, single_ms, want = single_steps(tcfg, 1)
    bf16_single_ms = single_steps(tcfg.replace(compute_dtype="bfloat16"), 2)[1]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        path = os.path.join(tmp, "a.pt")
        torch.save({"state": seeded, "batch": host, "want": want, "plain": False,
                    "deterministic": False}, path)
        t0 = time.perf_counter()
        ranks = launch.spawn(functools.partial(dp_train_rank, path), tcfg, DP_RANKS,
                             devices=["cuda:0"] * DP_RANKS, backend="gloo")
        spawn_s = time.perf_counter() - t0
        for r, out in enumerate(ranks):
            f32, bf16 = out["f32"], out["bf16"]
            if abs(f32["loss"] - single_loss) > DP_TOL["rtol"] * abs(single_loss):
                raise RuntimeError(f"rank {r}: f32 loss {f32['loss']!r}, one process "
                                   f"{single_loss!r}")
            if f32["diff"][0] > DP_TOL["atol"]:
                raise RuntimeError(f"rank {r}: state after the f32 step {f32['diff']} from one "
                                   f"process's, above {DP_TOL['atol']}")
            if f32["launches"] != dp_expected_launches(steps=1) or bf16["launches"] != \
                    dp_expected_launches(steps=2):
                raise RuntimeError(f"rank {r}: launches {f32['launches']} (f32 step), "
                                   f"{bf16['launches']} (2 bf16 steps)")
            if not all(math.isfinite(v) for v in bf16["losses"]):
                raise RuntimeError(f"rank {r}: bf16 losses {bf16['losses']}")
            launches[f"11a gloo rank {r}: 1 f32 + 2 bf16 steps"] = {
                k: f32["launches"][k] + bf16["launches"][k] for k in f32["launches"]}
        if len({out["f32"]["digest"] for out in ranks}) != 1:
            raise RuntimeError("the two ranks' states differ after the f32 step")
        info["11a"] = {"loss": [out["f32"]["loss"] for out in ranks], "single_loss": single_loss,
                       "state_diff": [out["f32"]["diff"] for out in ranks],
                       "bf16_losses": [out["bf16"]["losses"] for out in ranks],
                       "f32_step_ms": [out["f32"]["ms"] for out in ranks],
                       "single_f32_step_ms": single_ms,
                       "bf16_step_ms": [out["bf16"]["ms"] for out in ranks],
                       "single_bf16_step_ms": bf16_single_ms, "spawn_s": spawn_s}
        print(f"(a) DenseNet161-BTS 416x544, a global batch of {DP_BATCH} on {DP_RANKS} gloo "
              f"ranks sharing cuda:0: f32 loss {info['11a']['loss']!r} against one process's "
              f"{single_loss!r}; largest state difference {info['11a']['state_diff']!r} (atol "
              f"{DP_TOL['atol']}); the ranks' states equal; bf16 losses "
              f"{info['11a']['bf16_losses']!r}; launches a rank {ranks[0]['f32']['launches']} "
              f"(f32 step), {ranks[0]['bf16']['launches']} (2 bf16 steps); {spawn_s:.1f} s")
        print(f"(e) wall ms a step (a check, not a speed claim: gloo stages the gradients "
              f"through the host): two ranks f32 {info['11a']['f32_step_ms']!r} (the first, "
              f"cold), one process {single_ms!r} (cold); bf16 two ranks "
              f"{info['11a']['bf16_step_ms']!r}, one process {bf16_single_ms!r} (each a second "
              f"step; {smi})")

        # (f) The same f32 step on two gloo ranks for ResNet-50-BTS (its
        # trainable downsample.1 BNs go through the global BN) and the TF
        # graph (every BN frozen: only the gradients communicate);
        # deterministic cuDNN on both sides.
        runs = {}
        torch.backends.cudnn.deterministic = True
        try:
            for name, ecfg in (("resnet50_bts", tcfg.replace(encoder="resnet50_bts")),
                               ("densenet161_bts tf graph", tcfg.replace(model_flavor="tf"))):
                state = create_model(ecfg).state_dict()
                loss, _, after = single_steps(ecfg, 1, state)
                runs[name] = {"cfg": ecfg, "state": state, "want": after, "single_loss": loss}
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
        path = os.path.join(tmp, "f.pt")
        torch.save({"batch": host, "runs": {k: {c: v[c] for c in ("cfg", "state", "want")}
                                            for k, v in runs.items()}}, path)
        t0 = time.perf_counter()
        ranks = launch.spawn(functools.partial(dp_f32_rank, path), tcfg, DP_RANKS,
                             devices=["cuda:0"] * DP_RANKS, backend="gloo")
        spawn_s = time.perf_counter() - t0
        info["11f"] = {}
        for name, run in runs.items():
            got = [out[name] for out in ranks]
            for r, g in enumerate(got):
                if abs(g["loss"] - run["single_loss"]) > DP_TOL["rtol"] * abs(run["single_loss"]) \
                        or g["diff"][0] > DP_TOL["atol"] or g["launches"] != \
                        dp_expected_launches(steps=1):
                    raise RuntimeError(f"{name}, rank {r}: loss {g['loss']!r} against one "
                                       f"process's {run['single_loss']!r}, state difference "
                                       f"{g['diff']}, launches {g['launches']}")
            if len({g["digest"] for g in got}) != 1:
                raise RuntimeError(f"{name}: the two ranks' states differ after the step")
            launches[f"11f gloo rank 0: 1 f32 step, {name}"] = got[0]["launches"]
            info["11f"][name] = {"loss": [g["loss"] for g in got],
                                 "single_loss": run["single_loss"],
                                 "state_diff": [g["diff"] for g in got]}
            print(f"(f) {name} 416x544, a global batch of {DP_BATCH} on {DP_RANKS} gloo ranks "
                  f"sharing cuda:0, one f32 step: loss {info['11f'][name]['loss']!r} against "
                  f"one process's {run['single_loss']!r}; largest state difference "
                  f"{info['11f'][name]['state_diff']!r} (atol {DP_TOL['atol']}); the ranks' "
                  f"states equal; launches a rank {got[0]['launches']}")
        print(f"(f) {spawn_s:.1f} s for both graphs")
        del runs

        # (b) One rank over NCCL: the DDP step against the plain step.
        path = os.path.join(tmp, "b.pt")
        nb = DP_BATCH // DP_RANKS
        torch.save({"state": seeded, "batch": {k: v[:nb] for k, v in host.items()},
                    "want": None, "plain": True, "deterministic": True}, path)
        # In this process: a rank of its own saves a child's start-up.
        dp = mesh.init_data_parallel("cuda:0", "nccl", "file://" + os.path.join(tmp, "nccl"),
                                     world_size=1, rank=0)
        try:
            out = dp_train_rank(path, tcfg.replace(batch_size=nb), dp)
        finally:
            torch.distributed.destroy_process_group()
            torch.backends.cudnn.deterministic = False
        diff = out["plain"]["diff"]
        if diff[0] > DP_NCCL_ATOL or abs(out["f32"]["loss"] - out["plain"]["loss"]) > \
                1e-5 * abs(out["plain"]["loss"]):
            raise RuntimeError(f"NCCL rank: loss {out['f32']['loss']!r} against the plain "
                               f"step's {out['plain']['loss']!r}, state difference {diff}")
        if out["f32"]["launches"] != dp_expected_launches(steps=1):
            raise RuntimeError(f"NCCL rank: launches {out['f32']['launches']}")
        launches["11b NCCL rank: 1 f32 step"] = out["f32"]["launches"]
        info["11b"] = {"loss": out["f32"]["loss"], "plain_loss": out["plain"]["loss"],
                       "state_diff": diff}
        print(f"(b) one NCCL rank, DDP step against the plain step (batch {nb}, f32, "
              f"deterministic cuDNN): loss {out['f32']['loss']!r} against "
              f"{out['plain']['loss']!r}, largest state difference {diff!r} (atol "
              f"{DP_NCCL_ATOL}); launches {out['f32']['launches']}")

        # (c) cli.train through the launcher: two gloo ranks on cuda:0, the
        # recipe for DP_STEPS steps, an online eval every DP_EVAL_FREQ steps
        # over EVAL_FRAMES frames (batch 1: the ranks' forwards are one
        # process's).
        data = os.path.join(tmp, "data")
        manifest = write_nyu_frames(data, DP_BATCH * DP_STEPS)
        eval_manifest = write_manifest_head(manifest, "eval.txt", EVAL_FRAMES)
        log_dir = os.path.join(tmp, "logs")
        args_path, overrides = train_args(manifest, eval_manifest, log_dir)
        overrides += ["--eval_freq", str(DP_EVAL_FREQ), "--eval_batch_size", "1",
                      "--num_devices", str(DP_RANKS), "--dist_backend", "gloo",
                      "--device", ",".join(["cuda:0"] * DP_RANKS)]
        text = []
        t0 = time.perf_counter()
        with captured_fd_stdout(text):
            rc = cli_train.main(["@" + args_path, *overrides])
        cli_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.train on {DP_RANKS} ranks returned {rc}")
        steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(text[0])]
        if [gs for gs, _ in steps] != list(range(1, DP_STEPS + 1)) or not all(
                math.isfinite(loss) for _, loss in steps):
            raise RuntimeError(f"cli.train on {DP_RANKS} ranks logged {steps}")
        tables = text[0].count(f"Computing errors for {EVAL_FRAMES} eval samples")
        if tables != DP_STEPS // DP_EVAL_FREQ:
            raise RuntimeError(f"{tables} eval tables over {EVAL_FRAMES} samples, expected "
                               f"{DP_STEPS // DP_EVAL_FREQ}")
        if sorted(set(os.listdir(log_dir)) - {"eval"}) != ["bts_nyu_v2_tpu"]:  # eval: TensorBoard's
            raise RuntimeError(f"run dirs {os.listdir(log_dir)}")
        run_dir = os.path.join(log_dir, "bts_nyu_v2_tpu")
        best = best_checkpoints(run_dir)
        if sorted(best) != sorted(EVAL_METRICS) or list_step_checkpoints(run_dir):
            raise RuntimeError(f"cli.train on {DP_RANKS} ranks wrote {sorted(os.listdir(run_dir))}")
        by_step = {}  # step -> (a best file of it, [(metric index, logged value)])
        for metric, files in best.items():
            step, ckpt = files[-1]
            raw = load_checkpoint_dict(ckpt)
            if any(k.startswith("module.") for k in raw["model"]):
                raise RuntimeError(f"{ckpt} holds DDP's module. names")
            tracker, i = BestTracker.from_dict(raw), EVAL_METRICS.index(metric)
            logged = (tracker.lower[i] if i < NUM_LOWER_BETTER
                      else tracker.higher[i - NUM_LOWER_BETTER])
            by_step.setdefault(step, (ckpt, []))[1].append((i, float(logged)))
        eval_cfg = parse_args(["@" + args_path, *overrides])
        worst = 0.0
        for step, (ckpt, logged) in sorted(by_step.items()):
            fresh = create_model(eval_cfg).cuda()
            fresh.load_state_dict(load_checkpoint(ckpt), strict=True)
            got = run_online_eval(fresh, eval_cfg, verbose=False)
            for i, value in logged:
                np.testing.assert_allclose(got[i], value, rtol=1e-5, atol=0,
                                           err_msg=f"{EVAL_METRICS[i]} at step {step}")
                worst = max(worst, float(abs(got[i] - value) / abs(value)))
            del fresh
        info["11c"] = {"losses": [loss for _, loss in steps], "seconds": cli_s,
                       "best_steps": sorted(by_step), "max_rel_diff": worst}
        print(f"(c) cli.train --num_devices {DP_RANKS} (gloo ranks on cuda:0): losses "
              f"{info['11c']['losses']!r}, {tables} evals of {EVAL_FRAMES} frames (4 + 4), one "
              f"run dir by rank 0 with a best checkpoint per metric (plain names); a fresh "
              f"single-process model on each gives the logged measures (max rel diff "
              f"{worst!r}); {cli_s:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) The replicated forward on [cuda:0, cuda:0], batch 8 in two parts.
    scfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512)
    model = create_model(scfg).cuda().eval()
    x = torch.randn(DP_SERVE_BATCH, 3, 480, 640, generator=gen).cuda()
    focal = torch.full((DP_SERVE_BATCH,), 518.8579).cuda()
    with torch.inference_mode():
        single = model(x, focal)[-1][:, 0].float()
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 0.15)):
        fwd = make_sharded_forward(model, ["cuda:0"] * DP_RANKS, scfg.replace(compute_dtype=dtype))
        reset_kernel_counts()
        parts = fwd(x, focal)
        torch.cuda.synchronize()
        launched = kernel_counts()
        want_launches = dp_expected_launches(forwards=1, replicas=DP_RANKS)
        diff = float((torch.cat(parts) - single).abs().max())
        if [tuple(p.shape) for p in parts] != [(DP_SERVE_BATCH // DP_RANKS, 480, 640)] * \
                DP_RANKS or launched != want_launches or not diff < tol:
            raise RuntimeError(f"sharded forward {dtype}: shapes {[p.shape for p in parts]}, "
                               f"launches {launched} (expected {want_launches}), max abs diff "
                               f"{diff} m against the single f32 forward (tolerance {tol})")
        launches[f"11d sharded forward {dtype}, {DP_RANKS} replicas"] = launched
        info[f"11d_{dtype}_max_abs_diff"] = diff
        print(f"(d) make_sharded_forward on {DP_RANKS} replicas on cuda:0, {dtype}, batch "
              f"{DP_SERVE_BATCH} at 480x640: max abs diff {diff!r} m from the single f32 "
              f"forward (tolerance {tol}); launches {launched}")
        del fwd, parts
    del model
    torch.cuda.empty_cache()
    print(json.dumps({"data_parallel": info, "dp_launches": launches, "device": smi}))
    return launches


# Phase 12: a run resumed on the card, and checkpoints written in the
# background (--async_checkpoint).
RESUME_STEPS = 2  # steps before the save, and steps after the resume
ASYNC_TRAIN_STEPS, ASYNC_KEEP = 4, 2


def train_state_snapshot(st):
    """A run's whole state on the host: step, the model's state dict (BN
    statistics included), each moment and each group's two counts."""
    return {"step": st.step,
            "counts": {g: (grp["count"], grp["schedule_count"])
                       for g, grp in st.optimizer.groups.items()},
            "tensors": {**{f"model/{k}": v.detach().cpu().clone()
                           for k, v in st.model.state_dict().items()},
                        **{f"moment/{n}/{k}": v.detach().cpu().clone()
                           for n, s in st.optimizer.state.items() for k, v in s.items()}}}


def flat_tensors(d, prefix=""):
    """The tensors of a nested checkpoint dict by their path."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_tensors(v, f"{prefix}{k}/"))
        elif hasattr(v, "dtype"):
            out[prefix + k] = v
    return out


def first_unequal(torch, got, want):
    """The first path whose tensor differs in keys, dtype or any bit."""
    if got.keys() != want.keys():
        return f"keys differ: {sorted(got.keys() ^ want.keys())[:3]}"
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            return k
    return None


def host_ms(torch, fn):
    """Host ms of ``fn`` and the device work it enqueues."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def timed_save(torch, ckpt_lib, writer, path, st, async_save, step, plain_ms):
    """One save of ``st`` by ``writer`` then one ``step``: the ms of the
    call, the ms the two held the loop beyond ``plain_ms`` (a step alone),
    and how long after the step the file was written."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    writer.save(path, ckpt_lib.checkpoint_payload(st), async_save)
    call = (time.perf_counter() - t0) * 1e3
    step()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    writer.wait()
    return {"call_ms": call, "held_ms": total - plain_ms,
            "wait_after_step_ms": (time.perf_counter() - t1) * 1e3}


def phase12(torch, Config, create_model, create_optimizer, TrainState, make_train_step,
            cli_train, counts, reset_counts, smi):
    """Phase 12: (a) the f32 DenseNet161-BTS train step resumed through
    ``restore_training_start`` from a synchronous and from an asynchronous
    save, bit for bit against an uninterrupted run; (b) what each kind of
    save holds the loop for; (c) ``cli.train --async_checkpoint``. Returns
    the kernel launches of each path."""
    from bts_tpu_torch.training import checkpoint as ckpt_lib

    launches, info = {}, {}
    tcfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=2,
                  input_height=416, input_width=544)
    gen = torch.Generator().manual_seed(12)
    batches = [{"image": torch.randn(2, 416, 544, 3, generator=gen).cuda(),
                "depth": (torch.rand(2, 416, 544, 1, generator=gen) * 9.5 + 0.05).cuda(),
                "focal": torch.full((2,), 518.8579, device="cuda")}
               for _ in range(2 * RESUME_STEPS)]
    seeded = create_model(tcfg).state_dict()
    step = make_train_step(tcfg)

    def fresh(path=""):
        """The seeded run, or a fresh model and optimizer resumed from
        ``path`` as cli.train resumes."""
        c = tcfg.replace(checkpoint_path=path)
        model = create_model(c)
        model.load_state_dict(seeded, strict=True)
        model.cuda()
        optimizer, _ = create_optimizer(c, model, 1000)
        st, _ = ckpt_lib.restore_training_start(c, TrainState(model, optimizer),
                                                ckpt_lib.BestTracker())
        return st

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    torch.backends.cudnn.deterministic = True
    try:
        # (a) 4 f32 steps (TF32 off, as phase 3 set it) against 2, a save, a
        # resume and 2 more.
        whole = fresh()
        for b in batches:
            step(whole, b)
        want = train_state_snapshot(whole)
        del whole
        part = fresh()
        for b in batches[:RESUME_STEPS]:
            step(part, b)
        paths = {mode: os.path.join(tmp, f"model-{RESUME_STEPS}-{mode}")
                 for mode in ("sync", "async")}
        ckpt_lib.save_checkpoint(paths["sync"], part)
        ckpt_lib.save_checkpoint(paths["async"], part, async_save=True)
        ckpt_lib.wait_for_async_saves()
        saved = {m: flat_tensors(ckpt_lib.load_checkpoint_dict(p)) for m, p in paths.items()}
        bad = first_unequal(torch, saved["async"], saved["sync"])
        if bad:
            raise RuntimeError(f"the async save differs from the sync save at {bad}")
        nbytes = os.path.getsize(paths["sync"])
        for mode, path in paths.items():
            st = fresh(path)
            reset_counts()
            for b in batches[RESUME_STEPS:]:
                step(st, b)
            torch.cuda.synchronize()
            launched = counts()
            got = train_state_snapshot(st)
            del st
            expect = {"taps": 0, "eo": 0, "lpg": 3 * RESUME_STEPS,
                      "lpg_backward": 3 * RESUME_STEPS}
            if launched != expect:
                raise RuntimeError(f"resumed from the {mode} save: launches {launched}, "
                                   f"expected {expect}")
            bad = first_unequal(torch, got["tensors"], want["tensors"])
            if bad or (got["step"], got["counts"]) != (want["step"], want["counts"]):
                raise RuntimeError(f"resumed from the {mode} save: {bad or 'counts'} differs "
                                   f"from the uninterrupted run (step {got['step']}, counts "
                                   f"{got['counts']}; want {want['step']}, {want['counts']})")
            launches[f"12a {RESUME_STEPS} f32 steps resumed from the {mode} save"] = launched
        print(f"(a) DenseNet161-BTS f32 (TF32 off, deterministic cuDNN) 2x416x544: "
              f"{RESUME_STEPS} steps, a save, restore_training_start and {RESUME_STEPS} more "
              f"equal bit for bit to {2 * RESUME_STEPS} uninterrupted steps, from the sync and "
              f"from the async save ({len(want['tensors'])} tensors: parameters, BN statistics, "
              f"moments; counts {want['counts']}); the async file equals the sync file tensor "
              f"for tensor; launches {launched} ({RESUME_STEPS} steps)")

        # (b) What a save holds the loop for: the host ms from the save's call
        # to the end of the next step, less a plain step's ms (the median of
        # 3). Each kind on a fresh writer: its first save allocates the pinned
        # buffers, a later one reuses them.
        st = fresh(paths["sync"])

        plain = statistics.median(host_ms(torch, lambda: step(st, batches[0]))
                                  for _ in range(3))
        held = {}
        for async_save in (False, True):
            writer = ckpt_lib.CheckpointWriter()
            for name in (f"{'async' if async_save else 'sync'}_{n}" for n in ("first", "later")):
                held[name] = timed_save(torch, ckpt_lib, writer, os.path.join(tmp, name), st,
                                        async_save, lambda: step(st, batches[0]), plain)
        del st
        info["12b"] = {"bytes": nbytes, "plain_step_ms": plain, **held}
        print(f"(b) a checkpoint of {nbytes} bytes; a plain f32 step {plain!r} ms; held (save "
              f"call to the next step's end, less a plain step; host clock, a record and not a "
              f"claim; {smi}):")
        for name, h in held.items():
            print(f"    {name}: held {h['held_ms']!r} ms, the call {h['call_ms']!r} ms, the "
                  f"write done {h['wait_after_step_ms']!r} ms after the step")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) cli.train on the recipe, online eval off, a save every step, 2 kept,
    # written in the background.
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_nyu_frames(os.path.join(tmp, "data"), TRAIN_BATCH * ASYNC_TRAIN_STEPS)
        log_dir = os.path.join(tmp, "logs")
        args_path, overrides = train_args(manifest, manifest, log_dir)
        overrides += ["--no-do_online_eval", "--save_freq", "1", "--max_to_keep",
                      str(ASYNC_KEEP), "--async_checkpoint", "--model_name", "async_run"]
        capture = io.StringIO()
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(Tee(sys.stdout, capture)):
                rc = cli_train.main(["@" + args_path, *overrides])
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launched = counts()
        finally:
            os.chdir(cwd)
        steps = [(int(gs), float(loss)) for gs, _, loss in STEP_LINE.findall(capture.getvalue())]
        if rc != 0 or [gs for gs, _ in steps] != list(range(1, ASYNC_TRAIN_STEPS + 1)) or not \
                all(math.isfinite(loss) for _, loss in steps):
            raise RuntimeError(f"cli.train --async_checkpoint: rc {rc}, logged {steps}")
        if (launched["lpg_backward"] != 3 * ASYNC_TRAIN_STEPS
                or launched["lpg"] < 3 * ASYNC_TRAIN_STEPS or launched["taps"] or launched["eo"]):
            raise RuntimeError(f"cli.train --async_checkpoint: kernel launches {launched}")
        run_dir = os.path.join(log_dir, "async_run")
        kept = ckpt_lib.list_step_checkpoints(run_dir)
        want_kept = list(range(ASYNC_TRAIN_STEPS - ASYNC_KEEP + 1, ASYNC_TRAIN_STEPS + 1))
        if sorted(kept) != want_kept or any(n.endswith(".tmp") for n in os.listdir(run_dir)):
            raise RuntimeError(f"cli.train --async_checkpoint left {sorted(os.listdir(run_dir))}")
        for s, path in kept.items():
            ckpt = ckpt_lib.load_checkpoint_dict(path)
            if ckpt["global_step"] != s or not all(
                    bool(torch.isfinite(v).all()) for v in ckpt["model"].values()
                    if v.is_floating_point()):
                raise RuntimeError(f"{path}: global_step {ckpt['global_step']}, or not finite")
        launches["12c cli.train --async_checkpoint"] = launched
        info["12c"] = {"losses": [loss for _, loss in steps], "seconds": elapsed}
        print(f"(c) cli.train --async_checkpoint --save_freq 1 --max_to_keep {ASYNC_KEEP}: "
              f"{ASYNC_TRAIN_STEPS} steps at batch {TRAIN_BATCH} (bf16, device_augment), losses "
              f"{info['12c']['losses']!r}, kernel launches {launched}; kept "
              f"{['model-%d' % s for s in sorted(kept)]}, each loading with its step; "
              f"{elapsed:.1f} s including model build")
    print(json.dumps({"resume": info, "resume_launches": launches, "device": smi}))
    return launches


# Phase 13: the port's benchmark tools (bts_tpu_torch/tools/bench*.py) at
# their defaults; bench_zoo cut to 6 calls at delay 2, an encoder a call.
BENCH_ZOO_FLAGS = ["--iters", "6", "--delay", "2"]
DENSENET_LAYERS = {"densenet121_bts": 58, "densenet161_bts": DENSE_LAYERS}
BENCH_BATCH, BENCH_TRAIN_BATCH = 128, 16  # bench's and bench_train's defaults


def check_bench_forward(torch, fd, fdc):
    """Phase 13, ``bench``'s forward at its defaults (batch 128, its seeded
    image and weights): the kernels' form against the plain form, the depth
    maps within ``bench.LPG_CHECK_TOL_M``; and the taps wrapper on the first
    and the last dense layer of each block, given the NHWC views of the block
    buffers that forward filled (the strides it gave them; the first block's
    buffer holds 943M elements) and writing into a buffer of the same
    strides, against ``fused_dense_reference`` at DENSE_TOL, as is what the
    forward wrote there. Returns {"max_abs_diff_m", "taps": {shape: max abs
    err}}."""
    from bts_tpu_torch.models.encoders.densenet import DenseBlock
    from bts_tpu_torch.tools import bench, benchtools

    device = torch.device("cuda")
    (image,) = benchtools.seeded_images(BENCH_BATCH, 480, 640, device, n=1)
    focal = benchtools.focal(BENCH_BATCH, device)
    model, cfg = bench.load_form("default", "densenet161_bts", device)
    blocks = [m for m in model.encoder.modules() if isinstance(m, DenseBlock)]
    bufs = []
    hooks = [blk.register_forward_hook(lambda mod, args, out: bufs.append(out)) for blk in blocks]
    depth = bench.depth_map(model, cfg, image, focal, device).float()
    for hook in hooks:
        hook.remove()
    taps = {}
    with torch.inference_mode():
        for blk, buf in zip(blocks, bufs, strict=True):
            nhwc = buf.permute(0, 2, 3, 1)
            fresh = torch.empty_like(nhwc)
            name = str(nhwc.dtype).removeprefix("torch.")
            layers = list(blk.values())
            for layer in (layers[0], layers[-1]):
                c, g = layer.norm1.num_features, layer.conv2.out_channels
                s1, b1, w1, s2, b2, w2, _, kmajor = layer.folded(nhwc.dtype, False)
                x = nhwc[..., :c]
                got = fdc.fused_dense_cuda(x, s1, b1, w1, s2, b2, w2, out=fresh[..., c:c + g],
                                           kmajor=kmajor)
                want = fd.fused_dense_reference(x, s1, b1, w1, s2, b2, w2)
                torch.testing.assert_close(got, want, **DENSE_TOL[name])
                torch.testing.assert_close(nhwc[..., c:c + g], want, **DENSE_TOL[name])
                shape = f"B={BENCH_BATCH} {x.shape[1]}x{x.shape[2]} C={c} of {nhwc.shape[3]}"
                taps[shape] = (got.float() - want.float()).abs().max().item()
                print(f"bench dense taps {name} {shape}: against the plain version, max_abs_err "
                      f"{taps[shape]!r} (the forward's own channels within DENSE_TOL too)")
                del got, want
    del model, bufs, blk, buf, nhwc, fresh, x
    torch.cuda.empty_cache()
    model, cfg = bench.load_form("plain", "densenet161_bts", device)
    plain = bench.depth_map(model, cfg, image, focal, device).float()
    del model
    if not (bool(torch.isfinite(depth).all()) and bool(torch.isfinite(plain).all())):
        raise RuntimeError("bench forward at batch 128: a depth map is not finite")
    diff = (depth - plain).abs().max().item()
    print(f"bench forward B={BENCH_BATCH} 480x640 bf16: the kernels' form against the plain "
          f"form, max abs diff {diff!r} m (under {bench.LPG_CHECK_TOL_M} m)")
    if not diff < bench.LPG_CHECK_TOL_M:
        raise RuntimeError(f"bench forward at batch 128: the forms differ by {diff} m")
    torch.cuda.empty_cache()
    return {"max_abs_diff_m": diff, "taps": taps}


def check_bench_lpg(torch, lpg_cuda, lpg):
    """Phase 13, both LPG kernels at the tools' own shapes against their
    plain versions, the forward bit for bit, the backward within LPG_BWD_TOL
    (``lpg_backward_against_plain``): ``bench_lpg``'s six B=16 plane draws,
    the bare map and the gradient its forward+backward rows take (2 * map);
    ``bench_train``'s sites at batch 16 (decoded planes, ``/ MAX_DEPTH``), bf16
    out, f32 and bf16 gradients; ``bench``'s NYU sites at batch 128, the
    forward in f32 and bf16. Returns {case: backward max abs err, or 0.0 for
    a forward alone}."""
    from bts_tpu_torch.tools import bench_lpg

    gen = torch.Generator().manual_seed(13)
    res = {}

    def forward(pe, r, max_depth, dt):
        got = lpg_cuda.lpg_cuda(pe, r, max_depth, dt)
        want = (lpg.lpg_reference(pe, r) if max_depth is None
                else lpg.lpg_scaled_reference(pe, r, max_depth, dt))
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        return want

    def decoded(b, h, w):
        logits = torch.randn(b, h, w, 3, generator=gen).cuda()
        return lpg.normalize_plane(lpg.decode_plane_eq(logits, MAX_DEPTH)).contiguous()

    rng = np.random.default_rng(0)
    for r, h, w in bench_lpg.CASES:
        pe = torch.from_numpy(bench_lpg.seeded_planes(rng, h, w)).cuda()
        where = f"bench_lpg r={r} B={bench_lpg.B} grid {h}x{w}"
        depth = forward(pe, r, None, torch.float32)
        res[where], share = lpg_backward_against_plain(torch, lpg_cuda, lpg, pe, 2 * depth, r,
                                                       None, where)
        print(f"lpg {where}: forward bit-equal, backward max abs err {res[where]!r} (largest "
              f"error / terms' magnitude {share!r})")
    for r, h, w in TRAIN_SITES:
        pe = decoded(BENCH_TRAIN_BATCH, h, w)
        forward(pe, r, MAX_DEPTH, torch.bfloat16)
        for dt in (torch.float32, torch.bfloat16):
            grad = torch.randn(BENCH_TRAIN_BATCH, h * r, w * r, generator=gen).to(dt).cuda()
            where = (f"bench_train r={r} B={BENCH_TRAIN_BATCH} grid {h}x{w} grad "
                     f"{str(dt).removeprefix('torch.')}")
            res[where], share = lpg_backward_against_plain(torch, lpg_cuda, lpg, pe, grad, r,
                                                           MAX_DEPTH, where)
            print(f"lpg {where}: forward (bf16 out) bit-equal, backward max abs err "
                  f"{res[where]!r} (largest error / terms' magnitude {share!r})")
    for r, h, w in NYU_SITES:
        pe = decoded(BENCH_BATCH, h, w)
        for dt in (torch.float32, torch.bfloat16):
            forward(pe, r, MAX_DEPTH, dt)
        where = f"bench r={r} B={BENCH_BATCH} grid {h}x{w}"
        res[where] = 0.0
        print(f"lpg {where}: forward bit-equal in f32 and bf16 out")
    return res


@contextlib.contextmanager
def torch_defaults(torch):
    """PyTorch's own cuDNN and matmul settings, as a user's process has them
    (phases 3 and 11-12 turn TF32 off and cuDNN deterministic); restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = (
        True, False, False, False)
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def phase13(torch, counts, reset_counts, smi):
    """Phase 13: each benchmark tool through its ``main`` (its lines printed
    as the tool prints them, each after the card's), the counts reset just
    before each run and read just after: (a) ``bench``, 2 warm-up and 16
    timed forwards at batch 128, 78 taps and 3 LPG launches each, every sum
    read back finite; (b) ``bench --lpg-check`` at batch 64, the default
    form's 10 forwards (its map, a warm-up, 8 timed) through the kernels and
    the plain form's through none, the maps within 0.15 m; (c)
    ``bench_train``, 2 warm-up and 30 timed steps, 3 LPG forward and 3 LPG
    backward launches each, finite losses; (d) ``bench_zoo`` per encoder at
    batch 128 with ``BENCH_ZOO_FLAGS``, 8 forwards each, 3 LPG launches and
    the DenseNets' 58 or 78 taps a forward; (e) ``bench_lpg``, whose chains
    are captured as CUDA graphs, every row so timed: its counts are the
    wrapper calls captured (a replay launches without the wrapper), not the
    launches timed, a warm-up chain of 2 and the captured chain for K1 and
    K2 in each case's kernel rows. Then the kernels against their plain
    versions at these runs' shapes (``check_bench_forward``,
    ``check_bench_lpg``). Returns the launches of each run."""
    from bts_tpu_torch.ops import fused_dense, fused_dense_cuda, lpg, lpg_cuda
    from bts_tpu_torch.tools import bench, bench_lpg, bench_train, bench_zoo

    launches, records = {}, {}

    def run(label, tool, argv, forwards=0, steps=0, layers=DENSE_LAYERS, want=None):
        reset_counts()
        records[label] = tool.main(argv)
        torch.cuda.synchronize()
        launches[label] = got = counts()
        want = want or {"taps": layers * forwards, "eo": 0, "lpg": 3 * (forwards + steps),
                        "lpg_backward": 3 * steps}
        if got != want:
            raise RuntimeError(f"{label}: kernel launches {got}, expected {want}")
        print(f"{label}: kernel launches {got}", flush=True)

    torch.cuda.empty_cache()
    chain_calls = sum(2 + k for k in (bench_lpg.K1, bench_lpg.K2))  # warm-up + captured chain
    with torch_defaults(torch):
        run("bench", bench, [], forwards=2 + 16)
        run("bench --lpg-check", bench, ["--lpg-check"], forwards=1 + 1 + 8)
        run("bench_train", bench_train, [], steps=2 + 30)
        for enc in bench_zoo.ZOO:
            run(f"bench_zoo {enc}", bench_zoo, [enc, *BENCH_ZOO_FLAGS], forwards=2 + 6,
                layers=DENSENET_LAYERS.get(enc, 0))
            torch.cuda.empty_cache()
        run("bench_lpg (captured)", bench_lpg, [], want={
            "taps": 0, "eo": 0, "lpg": len(bench_lpg.CASES) * 2 * chain_calls,
            "lpg_backward": len(bench_lpg.CASES) * chain_calls})
        lpg_rows = records["bench_lpg (captured)"]
        if not all(row["method"] == "cuda_graph" and all(
                math.isfinite(row[f"{impl}_{kind}_us"]) for impl in bench_lpg.IMPLS
                for kind in ("fwd", "fwdbwd")) for row in lpg_rows):
            raise RuntimeError(f"bench_lpg: rows {lpg_rows}")
        checks = {"forward": check_bench_forward(torch, fused_dense, fused_dense_cuda),
                  "lpg": check_bench_lpg(torch, lpg_cuda, lpg)}
    print(json.dumps({"bench": records, "bench_launches": launches, "bench_checks": checks,
                      "device": smi}))
    return launches


# Phase 14: rematerialisation (--remat, --remat_policy, --remat_scope) in the
# train step. Each setting by its name; "off" is the step without remat.
REMAT_SETTINGS = {"off": {}, **{f"{p}/{s}": {"remat": True, "remat_policy": p, "remat_scope": s}
                                for p, s in (("conv", "encoder"), ("full", "encoder"),
                                             ("conv", "all"), ("full", "all"))}}
REMAT_BATCHES = (8, 16)
REMAT_TIMED_STEPS = 3
REMAT_TOL = DP_TOL  # phase 7(b)'s: loss rtol 1e-4, state atol 1e-4
REMAT_BIG = "conv/all"  # --remat --remat_scope all, the default policy


def remat_flags(setting):
    """A setting as bench_train's flags."""
    if not setting:
        return []
    return ["--remat", "--remat_policy", setting["remat_policy"], "--remat_scope",
            setting["remat_scope"]]


def remat_launches(setting, steps=1):
    """The kernel launches of ``steps`` train steps: 3 LPG forward and 3 LPG
    backward each, and 3 LPG forward more under scope ``all``, where the
    decoder's recompute calls the forward kernel again
    (tests/test_torch_remat.py counts the same calls on the CPU)."""
    again = 3 if setting.get("remat_scope") == "all" else 0
    return {"taps": 0, "eo": 0, "lpg": (3 + again) * steps, "lpg_backward": 3 * steps}


def remat_steps(torch, bench_train, create_optimizer, TrainState, make_train_step, model,
                batch, setting, batches, counts, reset_counts, steps=REMAT_TIMED_STEPS):
    """bench_train's bf16 step (its Config) at ``batch`` on ``model`` over
    ``batches`` (its host batches on the card), with a fresh optimizer: one
    warm-up step, then ``steps`` steps with the peak memory reset and the
    counts reset just before and read just after. Returns (peak bytes, ms a
    step, launches)."""
    cfg = bench_train.bench_config(bench_train.parse(["--batch", str(batch),
                                                      *remat_flags(setting)]))
    optimizer, _ = create_optimizer(cfg, model, 10_000)
    state, step = TrainState(model, optimizer), make_train_step(cfg)
    step(state, batches[-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launched, peak = counts(), torch.cuda.max_memory_allocated()
    model.zero_grad(set_to_none=True)
    if not torch.isfinite(loss):
        raise RuntimeError(f"remat {setting} batch {batch}: loss {loss.item()}")
    want = remat_launches(setting, steps)
    if launched != want:
        raise RuntimeError(f"remat {setting} batch {batch}: kernel launches {launched}, "
                           f"expected {want}")
    return peak, ms, launched


def bench_train_batches(torch, bench_train, batch, n=2):
    """The first ``n`` of bench_train's host batches at ``batch``, on the card."""
    from bts_tpu_torch.training.state import to_device

    args = bench_train.parse(["--batch", str(batch)])
    return [to_device(b, torch.device("cuda")) for b in bench_train.host_batches(args)[:n]]


def phase14(torch, Config, create_model, create_optimizer, TrainState, make_train_step, counts,
            reset_counts, smi):
    """Phase 14, rematerialisation (``models/remat.py``). Returns the kernel
    launches of each of its paths, by path."""
    import concurrent.futures
    import functools

    from bts_tpu_torch.apps import predict
    from bts_tpu_torch.parallel import launch
    from bts_tpu_torch.tools import bench_train

    launches, models, rows = {}, {}, {}
    total = torch.cuda.get_device_properties(0).total_memory
    GB = 1e9
    torch.cuda.empty_cache()
    tcfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  learning_rate=1e-4, weight_decay=1e-2, adam_eps=1e-3, batch_size=2,
                  input_height=416, input_width=544)
    gen = torch.Generator().manual_seed(14)

    # (d), started first: the ranks' start-up overlaps (b). One process's
    # f32 step with conv/all on 11(a)'s global batch (deterministic cuDNN),
    # then two gloo ranks sharing the card take it from the same state.
    dcfg = tcfg.replace(batch_size=DP_BATCH, device_augment=True, **REMAT_SETTINGS[REMAT_BIG])
    host = {"image": torch.rand(DP_BATCH, 427, 565, 3, generator=gen),
            "depth": torch.rand(DP_BATCH, 427, 565, 1, generator=gen) * 9.5 + 0.05,
            "focal": torch.full((DP_BATCH,), 518.8579)}
    model = create_model(dcfg)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    model.cuda()
    optimizer, _ = create_optimizer(dcfg, model, 1000)
    torch.backends.cudnn.deterministic = True
    try:
        single_loss = float(make_train_step(dcfg)(TrainState(model, optimizer),
                                                  {k: v.cuda() for k, v in host.items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    single = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, optimizer
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    path = os.path.join(tmp, "d.pt")
    torch.save({"batch": host, "runs": {REMAT_BIG: {"cfg": dcfg, "state": seeded,
                                                    "want": single}}}, path)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    ranks_future = pool.submit(launch.spawn, functools.partial(dp_f32_rank, path), dcfg,
                               DP_RANKS, devices=["cuda:0"] * DP_RANKS, backend="gloo")
    try:
        # (b) On each setting's fresh seeded model: one f32 step (TF32 off,
        # deterministic cuDNN) on 7(b)'s 2x416x544 batch, held to the step
        # without remat. (a) then steps the same models in bf16.
        dev = {"image": torch.randn(2, 416, 544, 3, generator=gen).cuda(),
               "depth": (torch.rand(2, 416, 544, 1, generator=gen) * 9.5 + 0.05).cuda(),
               "focal": torch.full((2,), 518.8579, device="cuda")}
        equal = {}
        for name, setting in REMAT_SETTINGS.items():
            cfg = tcfg.replace(**setting)
            model = models[name] = create_model(cfg).cuda()
            if (model.remat, model.remat_policy, model.remat_scope) != (
                    cfg.remat, cfg.remat_policy, cfg.remat_scope):
                raise RuntimeError(f"{name}: create_model dropped the remat fields")
            optimizer, _ = create_optimizer(cfg, model, 1000)
            torch.backends.cudnn.deterministic = True
            try:
                reset_counts()
                loss = float(make_train_step(cfg)(TrainState(model, optimizer), dev))
                launched = counts()
            finally:
                torch.backends.cudnn.deterministic = False
            if launched != remat_launches(setting):
                raise RuntimeError(f"{name} f32 step: kernel launches {launched}")
            launches[f"14b {name}: 1 f32 step"] = launched
            after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            del optimizer
            model.zero_grad(set_to_none=True)
            if name == "off":
                want_loss, want = loss, after
                continue
            worst = state_diff(after, want)  # raises unless every num_batches_tracked is equal
            bit = loss == want_loss and all(torch.equal(after[k], v) for k, v in want.items())
            if abs(loss - want_loss) > REMAT_TOL["rtol"] * abs(want_loss) or \
                    worst[0] > REMAT_TOL["atol"]:
                raise RuntimeError(f"{name} f32 step: loss {loss!r} against {want_loss!r} "
                                   f"without remat, largest state difference {worst}")
            equal[name] = {"loss": loss, "off_loss": want_loss, "bit_equal": bit,
                           "state_diff": worst}
            print(f"(b) {name}: f32 step against the step without remat (2x416x544, "
                  f"deterministic cuDNN): loss {loss!r} against {want_loss!r}; parameters and "
                  f"BN buffers {'bit-equal' if bit else f'largest difference {worst!r}'}; every "
                  f"num_batches_tracked equal; launches {launched}", flush=True)
        del dev
        ranks = ranks_future.result()
        spawn_s = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    got = [out[REMAT_BIG] for out in ranks]
    for r, g in enumerate(got):
        if abs(g["loss"] - single_loss) > DP_TOL["rtol"] * abs(single_loss) or \
                g["diff"][0] > DP_TOL["atol"] or g["launches"] != remat_launches(
                    REMAT_SETTINGS[REMAT_BIG]):
            raise RuntimeError(f"(d) rank {r}: loss {g['loss']!r} against one process's "
                               f"{single_loss!r}, state difference {g['diff']}, launches "
                               f"{g['launches']}")
    if len({g["digest"] for g in got}) != 1:
        raise RuntimeError("(d) the two ranks' states differ after the step")
    launches[f"14d gloo rank 0: 1 f32 step, {REMAT_BIG}"] = got[0]["launches"]
    two_ranks = {"loss": [g["loss"] for g in got], "single_loss": single_loss,
                 "state_diff": [g["diff"] for g in got], "bn_diff": [g["bn_diff"] for g in got],
                 "spawn_s": spawn_s}
    print(f"(d) {REMAT_BIG}: a global batch of {DP_BATCH} on {DP_RANKS} gloo ranks sharing "
          f"cuda:0, one f32 step against one process: loss {two_ranks['loss']!r} against "
          f"{single_loss!r}; largest state difference {two_ranks['state_diff']!r}, of the "
          f"global BN's buffers {two_ranks['bn_diff']!r} (atol {DP_TOL['atol']}); the ranks' "
          f"states equal; launches a rank {got[0]['launches']}; {spawn_s:.1f} s (beside (b))",
          flush=True)

    # (a) bench_train's bf16 step at batches 8 and 16: peak bytes, ms, launches.
    for batch in REMAT_BATCHES:
        batches = bench_train_batches(torch, bench_train, batch)
        for name, setting in REMAT_SETTINGS.items():
            peak, ms, launched = remat_steps(
                torch, bench_train, create_optimizer, TrainState, make_train_step, models[name],
                batch, setting, batches, counts, reset_counts)
            rows[name, batch] = {"peak_bytes": peak, "ms": ms,
                                 "lpg_forward_a_step": launched["lpg"] // REMAT_TIMED_STEPS,
                                 "lpg_backward_a_step":
                                     launched["lpg_backward"] // REMAT_TIMED_STEPS}
            launches[f"14a {name} b{batch}: {REMAT_TIMED_STEPS} bf16 steps"] = launched
        del batches
        torch.cuda.empty_cache()
    b0, b1 = REMAT_BATCHES
    slope = {name: (rows[name, b1]["peak_bytes"] - rows[name, b0]["peak_bytes"]) / (b1 - b0)
             for name in REMAT_SETTINGS}

    def extrapolated(name, batch):
        return rows[name, b1]["peak_bytes"] + slope[name] * (batch - b1)

    for name in REMAT_SETTINGS:
        print(f"(a) {name}: bf16 step 416x544 (bench_train's), peak "
              + ", ".join(f"{rows[name, b]['peak_bytes'] / GB:.3f} GB and "
                          f"{rows[name, b]['ms']:.2f} ms a step at batch {b}"
                          for b in REMAT_BATCHES)
              + f"; {slope[name] / GB:.4f} GB an image; LPG forward "
              f"{rows[name, b1]['lpg_forward_a_step']}, backward "
              f"{rows[name, b1]['lpg_backward_a_step']} a step", flush=True)

    # (c) The smallest multiple of 16 whose no-remat peak, extrapolated,
    # exceeds the card: one step there under --remat --remat_scope all, and
    # conv/encoder too if its own extrapolation fits. No step without remat.
    big = 16
    while extrapolated("off", big) <= total:
        big += 16
    large = {"batch": big, "total_bytes": total,
             "off_extrapolated_bytes": extrapolated("off", big)}
    batches = bench_train_batches(torch, bench_train, big, n=1)
    for name in (REMAT_BIG, "conv/encoder"):
        large[name] = {"extrapolated_bytes": extrapolated(name, big)}
        if extrapolated(name, big) > total:
            if name == REMAT_BIG:
                raise RuntimeError(f"(c) {name} at batch {big}: extrapolated peak "
                                   f"{extrapolated(name, big) / GB:.2f} GB exceeds the card's "
                                   f"{total / GB:.2f} GB")
            print(f"(c) {name} at batch {big}: extrapolated peak "
                  f"{extrapolated(name, big) / GB:.2f} GB exceeds the card's {total / GB:.2f} "
                  "GB: not run", flush=True)
            continue
        peak, ms, launched = remat_steps(
            torch, bench_train, create_optimizer, TrainState, make_train_step, models[name],
            big, REMAT_SETTINGS[name], batches, counts, reset_counts, steps=1)
        large[name].update(peak_bytes=peak, ms=ms)
        launches[f"14c {name} b{big}: 1 bf16 step"] = launched
        torch.cuda.empty_cache()
        print(f"(c) {name} at batch {big} (without remat about "
              f"{extrapolated('off', big) / GB:.2f} GB, over the card's {total / GB:.2f} GB): "
              f"peak {peak / GB:.3f} GB (extrapolated {extrapolated(name, big) / GB:.2f}), "
              f"{ms:.1f} ms; launches {launched}", flush=True)
    del batches
    models.clear()
    torch.cuda.empty_cache()

    # A cli.test forward (apps/predict.py) of a model built with --remat
    # --remat_scope all stays the serving path.
    icfg = Config(encoder="densenet161_bts", dataset="nyu", max_depth=MAX_DEPTH, bts_size=512,
                  remat=True, remat_scope="all")
    model = predict.load_model(icfg, torch.device("cuda"))
    x = torch.randn(1, 3, 480, 640, generator=gen).cuda()
    reset_counts()
    with torch.inference_mode(), predict.compute_context(icfg, torch.device("cuda")):
        outs = predict.forward_padded(model, x, torch.full((1,), 518.8579, device="cuda"))
    torch.cuda.synchronize()
    launched = counts()
    want = {"taps": DENSE_LAYERS, "eo": 0, "lpg": 3, "lpg_backward": 0}
    if launched != want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError(f"cli.test forward with --remat: launches {launched}, expected {want}")
    launches["14 cli.test forward, remat=True"] = launched
    print(f"cli.test forward (f32, 480x640) of a model built with --remat --remat_scope all: "
          f"launches {launched}", flush=True)
    del model, outs
    torch.cuda.empty_cache()
    print(json.dumps({"remat": {
        "steps": {f"{name} b{b}": r for (name, b), r in rows.items()},
        "bytes_an_image": slope, "large_batch": large, "equal": equal,
        "two_ranks": two_ranks, "launches": launches, "device": smi}}))
    return launches


# Phase 15's forwards: (label, encoder, dataset, max_depth, batch, (H, W),
# focal, dense_impl, flavor, dtypes, the launches a forward makes).
BOTH = ("bfloat16", "float32")
GRAPH_CASES = [
    ("densenet161 nyu b8", "densenet161_bts", "nyu", MAX_DEPTH, 8, (480, 640), 518.8579,
     "auto", "pt", BOTH, {"taps": DENSE_LAYERS, "eo": 0, "lpg": 3, "lpg_backward": 0}),
    ("densenet161 nyu b1", "densenet161_bts", "nyu", MAX_DEPTH, 1, (480, 640), 518.8579,
     "auto", "pt", BOTH, {"taps": DENSE_LAYERS, "eo": 0, "lpg": 3, "lpg_backward": 0}),
    ("resnext101 kitti b8", "resnext101_bts", "kitti", 80.0, 8, (352, 1216), 721.5377,
     "auto", "pt", BOTH, {"taps": 0, "eo": 0, "lpg": 3, "lpg_backward": 0}),
    ("densenet161 nyu b8 eo", "densenet161_bts", "nyu", MAX_DEPTH, 8, (480, 640), 518.8579,
     "eo", "pt", ("bfloat16",), {"taps": 0, "eo": DENSE_LAYERS, "lpg": 3, "lpg_backward": 0}),
    ("densenet161 nyu b8 tf", "densenet161_bts", "nyu", MAX_DEPTH, 8, (480, 640), 518.8579,
     "auto", "tf", ("bfloat16",), None),  # None: the eager forward's own launches
]
GRAPH_TIMED_CALLS = 10


def largest_gap(torch, got, want):
    """The largest absolute difference over the five outputs; 0.0 when every
    output is bit-equal."""
    return max((g.float() - w.float()).abs().max().item() if not torch.equal(g, w) else 0.0
               for g, w in zip(got, want, strict=True))


def call_ms(torch, fn, calls=GRAPH_TIMED_CALLS):
    """Medians of a call's host ms (until it returns) and wall ms (until the
    card is done), the card idle before each call."""
    host, wall = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def phase15(torch, Config, create_model, counts, reset_counts, smi):
    """Phase 15, the graphed inference forward (``models/graphed.py``), under
    PyTorch's default cuDNN and matmul settings: for each of GRAPH_CASES in
    its dtypes (bf16 autocast, f32), the third call of a call key (a replay)
    against the eager forward (``model._forward``) on the same weights and
    input, bit for bit; its launches, which must equal the eager forward's
    (and the case's expected taps, eo and 3 LPG where it gives them); the
    replay's outputs unchanged by the next call on another input, which
    matches its own eager forward; the counters (one eager call, one
    capture, the rest replays); then new weights by ``load_state_dict``
    (the graphs dropped at once) and the replay against the eager forward on
    them; then a weight changed in place, where the stale replay's outputs
    are dropped and the call returns the eager forward's; and the host and
    wall ms of an eager and a replayed call. Returns the replays' launches
    by case."""
    from bts_tpu_torch.models import graphed

    launches, report = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    with torch_defaults(torch):
        for (label, encoder, dataset, max_depth, batch, (h, w), f, dense_impl, flavor, dtypes,
             want) in GRAPH_CASES:
            cfg = Config(encoder=encoder, dataset=dataset, max_depth=max_depth, bts_size=512,
                         model_flavor=flavor)
            model = create_model(cfg).cuda().eval()
            if dense_impl != "auto":
                model.encoder.dense_impl = dense_impl
            xa, xb = (torch.randn(batch, 3, h, w, device="cuda", generator=gen) for _ in "ab")
            focal = torch.full((batch,), f, device="cuda")
            for dtype in dtypes:
                what = f"{label} {dtype}"
                with torch.inference_mode(), torch.autocast(
                        "cuda", dtype=torch.bfloat16, enabled=dtype == "bfloat16"):
                    reset_counts()
                    want_a = model._forward(xa, focal)
                    torch.cuda.synchronize()
                    eager_launched = counts()
                    want_b = model._forward(xb, focal)
                    c0 = (graphed.CAPTURES, graphed.REPLAYS, graphed.EAGER_FORWARDS)
                    model(xa, focal), model(xa, focal)  # eager, then capture
                    reset_counts()
                    got_a = model(xa, focal)
                    torch.cuda.synchronize()
                    launched = counts()
                    kept = [o.clone() for o in got_a]
                    got_b = model(xb, focal)
                    torch.cuda.synchronize()
                    moved = (graphed.CAPTURES - c0[0], graphed.REPLAYS - c0[1],
                             graphed.EAGER_FORWARDS - c0[2])
                    eager_ms = call_ms(torch, lambda: model._forward(xa, focal))
                    replay_ms = call_ms(torch, lambda: model(xa, focal))
                if launched != eager_launched or launched != (want or eager_launched):
                    raise RuntimeError(f"{what}: a replay launched {launched}, its eager forward "
                                       f"{eager_launched}, expected {want}")
                if moved != (1, 3, 1):
                    raise RuntimeError(f"{what}: (captures, replays, eager forwards) moved by "
                                       f"{moved}, expected (1, 3, 1)")
                gaps = {"replay": largest_gap(torch, got_a, want_a),
                        "next input": largest_gap(torch, got_b, want_b),
                        "after the next call": largest_gap(torch, got_a, kept)}
                if any(gaps.values()):
                    raise RuntimeError(f"{what}: the graphed forward is not the eager one bit "
                                       f"for bit, largest gaps {gaps}")
                launches[what] = launched
                report[what] = {"eager_host_ms": eager_ms[0], "eager_wall_ms": eager_ms[1],
                                "replay_host_ms": replay_ms[0], "replay_wall_ms": replay_ms[1]}
                print(f"{what}: replay bit-equal to eager (also on the next input, and its "
                      f"outputs after the next call); a replay launches {launched}; host ms a "
                      f"call eager {eager_ms[0]!r}, replay {replay_ms[0]!r}; wall ms eager "
                      f"{eager_ms[1]!r}, replay {replay_ms[1]!r} ({smi})", flush=True)
            # New weights: the held graphs go at once, and the graph captured
            # again computes with the new weights.
            fresh = create_model(cfg.replace(seed=cfg.seed + 1)).state_dict()
            model.load_state_dict(fresh)
            if model.forward_graphs.graphs:
                raise RuntimeError(f"{label}: load_state_dict left graphs held")
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                old = model(xa, focal)  # eager on the new weights
                want_new = model._forward(xa, focal)
                model(xa, focal)  # capture
                got_new = model(xa, focal)
            new_gap = largest_gap(torch, got_new, want_new)
            moved = largest_gap(torch, got_new, want_a)
            if new_gap or not moved or largest_gap(torch, old, want_new):
                raise RuntimeError(f"{label}: after load_state_dict the replay is {new_gap} from "
                                   f"the eager forward on the new weights and {moved} from the "
                                   "old weights' outputs")
            # A weight changed in place: the held graph replays on the old
            # weights, and the state check drops its outputs and the graph.
            with torch.no_grad():
                next(model.decoder.parameters()).mul_(0.5)
            replays = graphed.REPLAYS
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                got_edit = model(xa, focal)
                want_edit = model._forward(xa, focal)
            edit_gap, edited = largest_gap(torch, got_edit, want_edit), largest_gap(
                torch, got_edit, got_new)
            if edit_gap or not edited or graphed.REPLAYS != replays or model.forward_graphs.graphs:
                raise RuntimeError(f"{label}: after a weight changed in place the call is "
                                   f"{edit_gap} from the eager forward, {edited} from the old "
                                   f"weights' replay, {graphed.REPLAYS - replays} replays counted, "
                                   f"{len(model.forward_graphs.graphs)} graphs held")
            print(f"{label} bf16: after load_state_dict the replay is bit-equal to the eager "
                  f"forward on the new weights, {moved!r} from the old weights' outputs; after "
                  f"a weight changed in place the call is the eager forward, {edited!r} from "
                  "the stale replay's outputs", flush=True)
            del (model, fresh, xa, xb, want_a, want_b, got_a, got_b, kept, old, want_new, got_new,
                 got_edit, want_edit)
            torch.cuda.empty_cache()
    hits = graphed.REPLAYS / (graphed.REPLAYS + graphed.EAGER_FORWARDS)
    print(json.dumps({"graphs": {"calls": report, "launches": launches, "replays":
                                 graphed.REPLAYS, "eager_forwards": graphed.EAGER_FORWARDS,
                                 "captures": graphed.CAPTURES, "hit_share": hits,
                                 "device": smi}}))
    return launches


# Phase 16: NeWCRFs (--encoder large07). The window attention's calls of a
# batch-8 480x640 forward: (label, h, w of the token grid, channels, heads,
# form), each call twice a stage or level (unshifted, then shifted), 18 times
# in Swin's third stage: 32 launches a forward. Swin's Q, K and V are views
# of its qkv output, its pad rows the qkv bias's K and V; the CRF levels' Q
# and K are views of their qk output, V a (B, h, w, C) tensor, the pad rows
# the qk bias's K and zeros.
NEWCRFS_CALLS = [("swin stage 1", 120, 160, 192, 6, "swin"),
                 ("swin stage 2", 60, 80, 384, 12, "swin"),
                 ("swin stage 3", 30, 40, 768, 24, "swin"),
                 ("swin stage 4", 15, 20, 1536, 48, "swin"),
                 ("crf3", 15, 20, 1024, 32, "crf"), ("crf2", 30, 40, 512, 16, "crf"),
                 ("crf1", 60, 80, 256, 8, "crf"), ("crf0", 120, 160, 128, 4, "crf")]
NEWCRFS_LAUNCHES = 32
WINDOW_ATTN_SOURCE = "bts_tpu_torch/ops/window_attention.py (Triton)"
# The kernel against its plain version at the same rounding points: bf16
# outputs (ulp 2^-8 relative) may flip where the sums run in another order;
# f32 products in full f32 (ieee) against PyTorch's, 49-term sums.
WINDOW_ATTN_TOL = {"bfloat16": dict(rtol=1e-2, atol=1e-2), "float32": dict(rtol=1e-4, atol=1e-5)}
WINDOW_ATTN_PEAK = {"bfloat16": 989e12, "float32": 67e12}  # f32: FMAs, no tensor cores


# The LayerNorms of the same forward under bf16 autocast (``layers.LayerNorm``):
# (label, rows, C, input dtype, output dtype, calls), 76 calls. Stage 1's
# residual stream is float32 (``patch_embed.norm`` writes it); stages 2-4 and
# the CRF levels carry bf16; a norm read by a Linear or a convolution writes
# bf16, ``patch_embed.norm`` and ``norm3`` (pooled by the PSP) float32.
NEWCRFS_NORMS = [("patch_embed", 153600, 192, "bfloat16", "float32", 1),
                 ("swin stage 1 blocks, norm0", 153600, 192, "float32", "bfloat16", 5),
                 ("swin merge 1", 38400, 768, "float32", "bfloat16", 1),
                 ("swin stage 2 blocks, norm1", 38400, 384, "bfloat16", "bfloat16", 5),
                 ("swin merge 2", 9600, 1536, "bfloat16", "bfloat16", 1),
                 ("swin stage 3 blocks, norm2", 9600, 768, "bfloat16", "bfloat16", 37),
                 ("swin merge 3", 2400, 3072, "bfloat16", "bfloat16", 1),
                 ("swin stage 4 blocks", 2400, 1536, "bfloat16", "bfloat16", 4),
                 ("norm3", 2400, 1536, "bfloat16", "float32", 1),
                 ("crf3", 2400, 1024, "bfloat16", "bfloat16", 5),
                 ("crf2", 9600, 512, "bfloat16", "bfloat16", 5),
                 ("crf1", 38400, 256, "bfloat16", "bfloat16", 5),
                 ("crf0", 153600, 128, "bfloat16", "bfloat16", 5)]
NEWCRFS_NORM_LAUNCHES = 76
LAYER_NORM_SOURCE = "bts_tpu_torch/ops/layer_norm.py (Triton)"
# The kernel against its plain version: f32 sums in another order (a
# two-pass variance against PyTorch's Welford); bf16 outputs may then round
# one ulp (2^-8 to 2^-7 relative) apart.
LAYER_NORM_TOL = {"bfloat16": dict(rtol=1e-2, atol=1e-2), "float32": dict(rtol=1e-5, atol=1e-5)}


def window_attn_work(b, h, w, c, heads, pad_rows, shifted, esize, window=7, d=32):
    """(operations, bytes) of one call on the token grid: QK^T and PV over
    every window of the padded grid; q, k, v read and o written once a grid
    token in the dtype, ``pad_rows`` f32 pad rows, the f32 bias table, the
    int64 index and, shifted, the f32 mask once."""
    hp, wp = -(-h // window) * window, -(-w // window) * window
    n, n_w = window * window, (hp // window) * (wp // window)
    ops = 2 * 2 * b * n_w * heads * n * n * d
    nbytes = (esize * 4 * b * h * w * c + 4 * pad_rows * c + (2 * window - 1) ** 2 * heads * 4
              + n * n * 8 + (n_w * n * n * 4 if shifted else 0))
    return ops, nbytes


def window_attn_inputs(torch, b, h, w, c, heads, form, dtype, gen):
    """q, k, v (b, h, w, heads, 32) as the form's block hands them, and its
    float32 pad rows (random, far from zero; the CRF's V pad None)."""
    d = c // heads
    if form == "swin":
        qkv = torch.randn(b, h * w, 3 * c, device="cuda", generator=gen).to(dtype)
        grid = qkv.view(b, h, w, 3, heads, d)
        q, k, v = grid[..., 0, :, :], grid[..., 1, :, :], grid[..., 2, :, :]
        k_pad, v_pad = torch.randn(2, c, device="cuda", generator=gen)
    else:
        qk = torch.randn(b, h * w, 2 * c, device="cuda", generator=gen).to(dtype)
        grid = qk.view(b, h, w, 2, heads, d)
        q, k = grid[..., 0, :, :], grid[..., 1, :, :]
        v = torch.randn(b, h, w, heads, d, device="cuda", generator=gen).to(dtype)
        k_pad, v_pad = torch.randn(c, device="cuda", generator=gen), None
    return q, k, v, k_pad, v_pad


def check_layer_norm(torch, ln, gen):
    """Phase 16(f): the LayerNorm kernel against its plain version at each
    (rows, C) of NEWCRFS_NORMS, for bf16 and f32 inputs and outputs, random
    affine; its device ms beside its byte bound, the plain version's (the
    chain autocast runs: cast in, f32 norm, cast out) and ``F.layer_norm``'s
    on the input as it is (a bf16 input with its affine in bf16; in float32
    where the output is), then the cast (``library_ms``; the port never
    calls it). Returns the calls' records by "rows x C in->out" and the
    forward's sums over its 76 calls."""
    import torch.nn.functional as F

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    calls = {}
    for rows, c in dict.fromkeys((r, c) for _, r, c, *_ in NEWCRFS_NORMS):
        w = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        b = 0.1 * torch.randn(c, device="cuda", generator=gen)
        base = 3 + 2 * torch.randn(rows, c, device="cuda", generator=gen)
        for i_name, o_name in (("bfloat16", "bfloat16"), ("float32", "bfloat16"),
                               ("bfloat16", "float32"), ("float32", "float32")):
            x, out = base.to(dtypes[i_name]), dtypes[o_name]
            got = ln.layer_norm_triton(x, w, b, 1e-5, out)
            want = ln.layer_norm_plain(x, w, b, 1e-5, out)
            torch.cuda.synchronize()
            if got.dtype != out or got.shape != x.shape:
                raise RuntimeError(f"layer_norm {rows}x{c}: {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            torch.testing.assert_close(got.float(), want.float(), **LAYER_NORM_TOL[o_name])
            # PyTorch's norm takes its weight in the input's dtype.
            lib_x = x.float() if x.element_size() < got.element_size() else x
            lib_w, lib_b = w.to(lib_x.dtype), b.to(lib_x.dtype)
            ms = cuda_median_ms(lambda: ln.layer_norm_triton(x, w, b, 1e-5, out), samples=20)
            plain_ms = cuda_median_ms(lambda: ln.layer_norm_plain(x, w, b, 1e-5, out),
                                      samples=20)
            library_ms = cuda_median_ms(
                lambda: F.layer_norm(lib_x, (c,), lib_w, lib_b, 1e-5).to(out), samples=20)
            nbytes = rows * c * (x.element_size() + got.element_size()) + 8 * c
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            key = f"{rows}x{c} {i_name}->{o_name}"
            calls[key] = {"max_abs_err": err, "share_differing": differ, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                          "bound_by": "bytes", "roofline_pct": 100 * bound / ms}
            print(f"layer norm {key}: max abs err {err!r} ({differ:.2e} of outputs differ); "
                  f"{ms!r} ms, bound {bound!r} ms ({100 * bound / ms:.1f}%), plain "
                  f"{plain_ms!r} ms, F.layer_norm {library_ms!r} ms", flush=True)
            del x, got, want, lib_x, lib_w, lib_b
        del base
    forward = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for _, rows, c, i_name, o_name, n in NEWCRFS_NORMS:
        for k in forward:
            forward[k] += n * calls[f"{rows}x{c} {i_name}->{o_name}"][k]
    forward["roofline_pct"] = 100 * forward["bound_ms"] / forward["ms"]
    f32 = {k: sum(calls[f"{rows}x{c} float32->float32"][k] * n
                  for _, rows, c, *_, n in NEWCRFS_NORMS) for k in ("ms", "library_ms")}
    print(f"layer norm, a large07 b8 bf16 forward's {NEWCRFS_NORM_LAUNCHES} calls: kernel "
          f"{forward['ms']!r} ms, bound {forward['bound_ms']!r} ms "
          f"({forward['roofline_pct']:.1f}%), plain (autocast's chain) {forward['plain_ms']!r} "
          f"ms, F.layer_norm {forward['library_ms']!r} ms; the same calls f32 in and out: "
          f"kernel {f32['ms']!r} ms, F.layer_norm {f32['library_ms']!r} ms", flush=True)
    return calls, {**forward, "float32": f32}


def phase16(torch, Config, create_model, smi):
    """Phase 16, NeWCRFs (``models/newcrfs.py``, ``ops/window_attention.py``):
    (a) the window-attention kernel on the token grid against its plain
    version at each of NEWCRFS_CALLS at batch 8, bf16 and f32, shifted and
    not, q, k, v and the random non-zero pad rows as each block hands them;
    its device ms beside its bound, the plain version's and SDPA's
    (``library_ms``, on windows cut out beforehand; the port never calls
    it); (b) the published ``large07`` at NYU 480x640, batch 8, seeded,
    every bias drawn at 0.1 * randn so that padded tokens' keys matter and
    every norm's weight at 1 + 0.1 * randn so that the affine matters: the
    bf16 program's depth (graph replay, inference mode) against the float32
    reference (``tests/newcrfs_reference.py``, TF32 off); (c) the replay
    bit-equal to the eager forward, 32 window-attention and 76 LayerNorm
    launches a replay, the graphs dropped on ``load_state_dict``; eager and
    replay ms and img/s; the eager and the replayed forward profiled by
    ``tools/profile_forward.py --encoder large07``: 32 ``window_attn_kernel``
    and 76 ``layer_norm_kernel`` launches, no ``roll`` kernel and no
    ``vectorized_layer_norm_kernel`` a forward; (d) the forward's peak
    memory; (e) ``cli.test --encoder large07`` over 8 NYU frames in bf16 at
    batch 8: 8 pngs, 32 and 76 launches a forward, and ``--save_lpg``
    refused; (f) the LayerNorm kernel against its plain version at the
    forward's norm shapes (``check_layer_norm``). Returns the two kernels'
    records."""
    import torch.nn.functional as F

    from bts_tpu_torch.cli import test as cli_test
    from bts_tpu_torch.models.encoders.swin import relative_position_index, shift_mask
    from bts_tpu_torch.ops import layer_norm as ln
    from bts_tpu_torch.ops import window_attention as wa
    from bts_tpu_torch.tools import profile_forward

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import newcrfs_reference

    gen = torch.Generator(device="cuda").manual_seed(16)
    index = relative_position_index(7).cuda()
    scale = 32 ** -0.5
    calls = {}
    for label, h, w, c, heads, form in NEWCRFS_CALLS:
        hp, wp = wa.padded_grid(h, w, 7)
        mask = shift_mask(hp, wp, 7, 3, "cuda")
        table = 0.02 * torch.randn(169, heads, device="cuda", generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v, k_pad, v_pad = window_attn_inputs(torch, 8, h, w, c, heads, form, dtype,
                                                       gen)
            args = (table, index, mask, scale, 7, 3, k_pad, v_pad)
            err = 0.0
            for shift, m in ((0, None), (3, mask)):
                got = wa.window_attention_triton(q, k, v, table, index, m, scale, 7, shift,
                                                 k_pad, v_pad)
                want = wa.window_attention_plain(q, k, v, table, index, m, scale, 7, shift,
                                                 k_pad, v_pad)
                torch.cuda.synchronize()
                err = max(err, (got.float() - want.float()).abs().max().item())
                torch.testing.assert_close(got.float(), want.float(), **WINDOW_ATTN_TOL[name])
            ms = cuda_median_ms(lambda: wa.window_attention_triton(q, k, v, *args), samples=20)
            plain_ms = cuda_median_ms(lambda: wa.window_attention_plain(q, k, v, *args),
                                      samples=5, reps=2)
            bias = table[index.view(-1)].view(49, 49, heads).permute(2, 0, 1)
            full = (bias[None] + mask[:, None]).to(dtype)  # (nW, heads, N, N)
            n_w, idx = mask.shape[0], wa.grid_index(8, h, w, 7, 3, "cuda")
            per = [torch.cat([t.reshape(-1, heads, 32), t.new_zeros(1, heads, 32)])[idx]
                   .view(8, n_w, 49, heads, 32).permute(0, 1, 3, 2, 4) for t in (q, k, v)]
            library_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(
                *per, attn_mask=full, scale=scale), samples=10)
            ops, nbytes = window_attn_work(8, h, w, c, heads, 1 if v_pad is None else 2, True,
                                           q.element_size())
            t_ops = ops / WINDOW_ATTN_PEAK[name] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            calls[f"{label} {name}"] = {
                "grid": [8, h, w], "heads": heads, "form": form, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "roofline_pct": 100 * bound / ms}
            print(f"window attention {label} (8x{h}x{w} grid, {heads} heads, {form} pads) "
                  f"{name}: max abs err {err!r}; {ms!r} ms (shifted), bound {bound!r} ms "
                  f"({calls[f'{label} {name}']['bound_by']}, {100 * bound / ms:.1f}%), plain "
                  f"{plain_ms!r} ms, SDPA {library_ms!r} ms ({smi})", flush=True)
            del q, k, v, k_pad, v_pad, got, want, full, per

    # (f) the LayerNorm kernel at the forward's norm shapes.
    norm_calls, norm_forward = check_layer_norm(torch, ln, gen)
    torch.cuda.empty_cache()

    def launches():
        return wa.LAUNCHES, ln.LAUNCHES

    want_launches = (NEWCRFS_LAUNCHES, NEWCRFS_NORM_LAUNCHES)

    # (b)-(d) the published model, seeded, NYU 480x640 at batch 8.
    cfg = Config(encoder="large07", dataset="nyu", max_depth=10.0, seed=16)
    model = create_model(cfg).cuda().eval()
    params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():  # non-zero biases: a padded token's K and V are qkv's and qk's bias
        bias_gen = torch.Generator().manual_seed(16)
        for key, p in model.named_parameters():
            if key.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=bias_gen))
            elif key.endswith("weight") and p.dim() == 1:  # every norm's, off identity
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=bias_gen))
    x = torch.randn(8, 3, 480, 640, device="cuda", generator=gen)
    x2 = torch.randn(8, 3, 480, 640, device="cuda", generator=gen)
    focal = torch.full((8,), 518.8579, device="cuda")
    with torch_defaults(torch):
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            before = launches()
            eager, = model._forward(x, focal)
            torch.cuda.synchronize()
            eager_launches = tuple(a - b for a, b in zip(launches(), before))
            model(x, focal), model(x, focal)  # eager, then the capture and its replay
            before = launches()
            replay, = model(x, focal)
            torch.cuda.synchronize()
            replay_launches = tuple(a - b for a, b in zip(launches(), before))
            peak = torch.cuda.max_memory_allocated()
            eager_ms = call_ms(torch, lambda: model._forward(x2, focal), calls=5)
            replay_ms = call_ms(torch, lambda: model(x2, focal), calls=10)
        if (eager_launches, replay_launches) != (want_launches, want_launches):
            raise RuntimeError(f"large07: (window-attention, LayerNorm) launches "
                               f"{eager_launches} eager, {replay_launches} a replay, expected "
                               f"{want_launches}")
        if not torch.equal(replay, eager):
            raise RuntimeError(f"large07: the replay is {largest_gap(torch, [replay], [eager])} "
                               "from the eager forward")
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                               "configs", "newcrfs-nyu-swinl07.json")) as f:
            ref = newcrfs_reference.NeWCRFs(json.load(f)).cuda().eval()
        ref.load_state_dict(model.state_dict())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            want = torch.cat([ref(x[i:i + 2], focal[i:i + 2]) for i in range(0, 8, 2)])
        torch.backends.cudnn.allow_tf32 = True
        gap = (replay - want).abs()
        absrel, max_m = (gap / want).mean().item(), gap.max().item()
        del ref, want
        if absrel > 0.004 or max_m > 1.0:
            raise RuntimeError(f"large07 bf16 against the f32 reference: absrel {absrel}, "
                               f"max {max_m} m")
        # New weights: the graphs go at once; the new replay matches its eager forward.
        model.load_state_dict(create_model(cfg.replace(seed=17)).state_dict())
        if model.forward_graphs.graphs:
            raise RuntimeError("large07: load_state_dict left graphs held")
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x, focal), model(x, focal)
            new, = model(x, focal)
            new_eager, = model._forward(x, focal)
        if not torch.equal(new, new_eager) or torch.equal(new, replay):
            raise RuntimeError("large07: after load_state_dict the replay is not the new "
                               "weights' eager forward")
    print(f"large07 ({params} parameters) NYU 480x640 b8 bf16 against the f32 reference: "
          f"depth absrel {absrel!r}, max {max_m!r} m; replay bit-equal to eager, "
          f"{replay_launches} (window-attention, LayerNorm) launches a replay; ms a batch eager "
          f"{eager_ms[1]!r}, replay {replay_ms[1]!r} ({8e3 / replay_ms[1]:.1f} img/s); "
          f"peak {peak} bytes ({smi})", flush=True)
    del model, x, x2, eager, replay, new, new_eager
    torch.cuda.empty_cache()

    # (c) The eager and the replayed forward profiled: the window attention
    # in 32 launches and the LayerNorms in 76 a forward, no roll kernel and
    # no PyTorch LayerNorm.
    runs = profile_forward.main(["--encoder", "large07", "--batches", "8"])
    for run in runs:
        attn = sum(n for k, n in run["launches"].items() if "window_attn_kernel" in k)
        norms = sum(n for k, n in run["launches"].items()
                    if "layer_norm_kernel" in k and "vectorized" not in k)
        stray = {k: n for k, n in run["launches"].items()
                 if "roll_cuda" in k or "vectorized_layer_norm" in k}
        if (attn, norms) != want_launches or stray:
            raise RuntimeError(f"large07 {run['forward']} forward: {attn} window-attention "
                               f"and {norms} LayerNorm launches, stray kernels {stray}")
    profiles = {f"{r['forward']} {i}": {
        "device_ms": r["device_ms"], "kernels": r["kernels"], "by_kind_ms": r["by_kind_ms"],
        "copies": {k: n for k, n in r["launches"].items() if "copy" in k.lower()}}
        for i, r in enumerate(runs)}
    print(f"large07 profiled b8 bf16: {NEWCRFS_LAUNCHES} window_attn_kernel and "
          f"{NEWCRFS_NORM_LAUNCHES} layer_norm_kernel launches, no roll kernel and no "
          f"vectorized_layer_norm_kernel a forward, eager and replayed; {json.dumps(profiles)} "
          f"({smi})", flush=True)
    torch.cuda.empty_cache()

    # (e) cli.test --encoder large07.
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_nyu_frames(os.path.join(tmp, "data"), 8)
        argv = ["--encoder", "large07", "--dataset", "nyu", "--max_depth", "10",
                "--input_height", "480", "--input_width", "640", "--compute_dtype", "bfloat16",
                "--eval_batch_size", "8", "--data_path", os.path.join(tmp, "data"),
                "--filenames_file", manifest, "--model_name", "newcrfs"]
        os.chdir(tmp)
        try:
            try:
                cli_test.main(argv + ["--save_lpg"])
                raise RuntimeError("cli.test --encoder large07 --save_lpg ran")
            except ValueError as err:
                print(f"cli.test --encoder large07 --save_lpg refused: {err}")
            before = launches()
            if cli_test.main(argv) != 0:
                raise RuntimeError("cli.test --encoder large07 failed")
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(launches(), before))
        finally:
            os.chdir(cwd)
        check_pngs(os.path.join(tmp, "result_newcrfs", "raw"), 8, (480, 640), np.uint16)
    if launched != want_launches:
        raise RuntimeError(f"cli.test --encoder large07: (window-attention, LayerNorm) "
                           f"launches {launched}, expected {want_launches} (one forward)")
    print(f"cli.test --encoder large07: 8 uint16 pngs, {launched} (window-attention, "
          f"LayerNorm) launches")
    record = {"name": "window_attention", "route": "triton", "source": WINDOW_ATTN_SOURCE,
              "replaces": None, "launches_per_forward": NEWCRFS_LAUNCHES, "calls": calls,
              "model": {"parameters": params, "depth_absrel": absrel, "depth_max_m": max_m,
                        "eager_ms": eager_ms[1], "replay_ms": replay_ms[1],
                        "peak_bytes": peak, "profiles": profiles}, "device": smi}
    norm_record = {"name": "layer_norm", "route": "triton", "source": LAYER_NORM_SOURCE,
                   "replaces": None, "launches_per_forward": NEWCRFS_NORM_LAUNCHES,
                   "calls": norm_calls, "forward": norm_forward, "device": smi}
    print(json.dumps({"window_attention": record, "layer_norm": norm_record}))
    return record, norm_record


DAV2_SHAPE = (8, 16, 4737, 64)  # the KITTI cell's call: (B, heads, N, d)
DAV2_LAUNCHES = (24, 52)  # global attention, LayerNorm: a dav2_vitl forward
GLOBAL_ATTN_SOURCE = "bts_tpu_torch/ops/global_attention.py (Triton)"
GLOBAL_ATTN_PEAK = {"bfloat16": 989e12, "float32": 67e12}  # f32: FMAs, no tensor cores
# Tile settings (BLOCK_M, BLOCK_N, warps, stages) timed beside the kernel's own.
GLOBAL_ATTN_CONFIGS = [(128, 64, 4, 3), (128, 64, 8, 3), (128, 64, 8, 4), (128, 128, 8, 3),
                       (64, 64, 8, 3), (128, 32, 4, 4)]
# The published model, seeded and drawn off its defaults, at KITTI's frame,
# batch 8, against the f32 reference: the f32 forward (TF32 off) computes
# the reference's equations in another order (1e-5 relative measured); the
# bf16 forward differs by bf16's rounding, amplified through 24 blocks and
# the head into the sigmoid's logit (0.019-0.030 AbsRel and 2.1-3.8 m
# measured with these weights; the cell's float8 control reads 17-40 m).
DAV2_GATES = {"float32": (1e-4, 0.01), "bfloat16": (0.06, 10.0)}


def global_attn_check(torch, ga, b, n, dtype, gen):
    """The kernel against its plain version (one image at a time) on q, k,
    v as views of one (b, n, 3, 16, 64) ``qkv`` output: (inputs, max abs
    error, tolerance). bf16 within one bf16 ulp of the output's largest
    magnitude, f32 within 1e-5."""
    qkv = torch.randn(b, n, 3, 16, 64, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = ga.global_attention_triton(q, k, v, 0.125)
    want = torch.cat([ga.global_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], 0.125)
                      for i in range(b)])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = (2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
           if dtype == torch.bfloat16 else 1e-5)
    if got.shape != (b, n, 16 * 64) or got.dtype != dtype or not err <= tol:
        raise RuntimeError(f"global attention ({b}, 16, {n}, 64) {dtype}: max abs error {err} "
                           f"over {tol}, {tuple(got.shape)} {got.dtype}")
    return (q, k, v), err, tol


def dav2_perturb(torch, model, seed):
    """Every bias at 0.1 * randn, every norm's weight and LayerScale at
    1 + 0.1 * randn: the seeded defaults (0 and 1) would hide them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif key.endswith(("weight", "gamma")) and p.dim() == 1:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))


def write_kitti_frames(root, n=8, h=375, w=1242):
    """``n`` seeded KITTI-sized frames (kb_crop takes them to 352x1216) and
    their manifest, gt 'None'."""
    rng = np.random.default_rng(17)
    rel = "2011_09_26/2011_09_26_drive_0002_sync/image_02/data"
    os.makedirs(os.path.join(root, rel))
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, rel, f"{i:010d}.png"))
        lines.append(f"{rel}/{i:010d}.png None 721.5377")
    manifest = os.path.join(root, "files.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def dav2_cell_checks(torch):
    """The KITTI cell's check (``benchmark/drivers/serve_closed.py``: seeded
    weights and frames, the dumper's calls for 2 s, the kept depth maps
    against the float32 reference) of the program and of each planted
    fault of ``tests/test_torch_depth_anything.py``, monkeypatched in:
    {name: (depth_absrel, depth_max_m, within the cell's limits)}."""
    import pytest

    import test_torch_depth_anything as faults
    from benchmark import spec
    from benchmark.drivers import serve_closed
    from bts_tpu_torch.models import depth_anything
    from bts_tpu_torch.models.encoders import vit

    cell = spec.cell(spec.benchmark(), "kitti-dav2l-serve-b8")
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    patches = {
        "sound": [],
        "no attention scale": [(vit, "global_attention",
                                faults.fake_no_scale(vit.global_attention))],
        "pos-embed by size": [(vit.DinoVisionTransformer, "position_embedding",
                               faults.pos_by_size)],
        "LayerScale dropped": [(vit.LayerScale, "forward", lambda self, x: x)],
        "class token not a key": [(vit, "global_attention",
                                   faults.fake_cls_not_a_key(vit.global_attention))],
        "taps off by one": [(vit.DinoVisionTransformer, "forward",
                             faults.taps_before_their_block)],
        "head resize corners off": [(depth_anything, "F", faults.CornersOff())],
    }
    out = {}
    for i, (name, sets) in enumerate(patches.items()):
        with pytest.MonkeyPatch.context() as mp:
            for obj, attr, value in sets:
                mp.setattr(obj, attr, value)
            serving = serve_closed.Driver(config, traffic, 2400017 + i, torch.device("cuda"))
            serving.window(2.0)
            serving.release()
        numbers = serving.check()
        held = all(numbers[k] <= v for k, v in limits.items())
        out[name] = (numbers["depth_absrel"], numbers["depth_max_m"], held)
        print(f"kitti-dav2l-serve-b8 check, {name}: depth_absrel {numbers['depth_absrel']!r}, "
              f"depth_max_m {numbers['depth_max_m']!r}, within {limits}: {held}", flush=True)
        del serving
        torch.cuda.empty_cache()
    if not out["sound"][2]:
        raise RuntimeError(f"kitti-dav2l-serve-b8: the program's check fails: {out['sound']}")
    return out


def phase17(torch, Config, create_model, smi):
    """Phase 17, Depth Anything V2 (``models/depth_anything.py``,
    ``models/encoders/vit.py``, ``ops/global_attention.py``): the steps of
    the docstring's item 17. Returns the kernel's record."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bts_tpu_torch.cli import test as cli_test
    from bts_tpu_torch.ops import global_attention as ga
    from bts_tpu_torch.ops import layer_norm as ln
    from bts_tpu_torch.tools import profile_forward

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import depth_anything_reference

    # (a) the kernel at the cell's call and at small N, both dtypes.
    gen = torch.Generator(device="cuda").manual_seed(17)
    b, heads, n, d = DAV2_SHAPE
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for nb, nn_ in ((2, 64), (2, 65), (2, 128), (2, 1815), (b, n)):
            (q, k, v), err, tol = global_attn_check(torch, ga, nb, nn_, dtype, gen)
            calls[f"({nb}, 16, {nn_}, 64) {name}"] = {"max_abs_err": err, "tolerance": tol}
            print(f"global attention ({nb}, 16, {nn_}, 64) {name}: max abs error {err!r} "
                  f"(tolerance {tol!r})", flush=True)
        ops, nbytes = 4 * b * heads * n * n * d, 4 * b * heads * n * d * q.element_size()
        t_ops, t_bytes = ops / GLOBAL_ATTN_PEAK[name] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        ms = cuda_median_ms(lambda: ga.global_attention_triton(q, k, v, 0.125), samples=10,
                            reps=3)
        plain_ms = cuda_median_ms(lambda: ga.global_attention_plain(q[:1], k[:1], v[:1], 0.125),
                                  samples=3, reps=1, warmup=1) * b
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        library = {}
        for label, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                               ("cudnn", SDPBackend.CUDNN_ATTENTION)):
            try:
                with sdpa_kernel([backend]):
                    library[label] = cuda_median_ms(
                        lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125),
                        samples=10, reps=3)
            except RuntimeError as err:  # the backend does not take this dtype or layout
                library[label] = None
                print(f"SDPA {label} {name}: {str(err).splitlines()[0]}", flush=True)
        tiles = {}
        if dtype == torch.bfloat16:
            for config in GLOBAL_ATTN_CONFIGS:
                got = ga.global_attention_triton(q, k, v, 0.125, config)
                want = ga.global_attention_triton(q, k, v, 0.125)
                torch.cuda.synchronize()
                gap = (got.float() - want.float()).abs().max().item()
                tiles[str(config)] = cuda_median_ms(
                    lambda: ga.global_attention_triton(q, k, v, 0.125, config), samples=10,
                    reps=3)
                print(f"global attention tiles {config}: {tiles[str(config)]!r} ms "
                      f"({100 * bound / tiles[str(config)]:.1f}% of the bound), "
                      f"{gap!r} from the kernel's own", flush=True)
        calls[f"cell {name}"] = {"shape": list(DAV2_SHAPE), "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": library, "bound_ms": bound,
                                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                                 "roofline_pct": 100 * bound / ms, "tiles_ms": tiles}
        print(f"global attention {DAV2_SHAPE} {name} (tiles {ga.CONFIGS[dtype]}): {ms!r} ms, "
              f"bound {bound!r} ms ({100 * bound / ms:.1f}%), {ops / ms / 1e9:.1f} TFLOP/s, "
              f"plain {plain_ms!r} ms, SDPA {library} ({smi})", flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()

    def launches():
        return ga.LAUNCHES, ln.LAUNCHES

    # (b)-(c) the published model, seeded, KITTI 352x1216 at batch 8.
    cfg = Config(encoder="dav2_vitl", dataset="kitti", max_depth=80.0, seed=17)
    model = create_model(cfg).cuda().eval()
    params = sum(p.numel() for p in model.parameters())
    dav2_perturb(torch, model, 17)
    x = torch.randn(8, 3, 352, 1216, device="cuda", generator=gen)
    x2 = torch.randn(8, 3, 352, 1216, device="cuda", generator=gen)
    focal = torch.full((8,), 721.5377, device="cuda")
    with torch_defaults(torch):
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            before = launches()
            eager, = model._forward(x, focal)
            torch.cuda.synchronize()
            eager_launches = tuple(a - b_ for a, b_ in zip(launches(), before))
            model(x, focal), model(x, focal)  # eager, then the capture and its replay
            before = launches()
            replay, = model(x, focal)
            torch.cuda.synchronize()
            replay_launches = tuple(a - b_ for a, b_ in zip(launches(), before))
            peak = torch.cuda.max_memory_allocated()
            eager_ms = call_ms(torch, lambda: model._forward(x2, focal), calls=5)
            replay_ms = call_ms(torch, lambda: model(x2, focal), calls=10)
        if (eager_launches, replay_launches) != (DAV2_LAUNCHES, DAV2_LAUNCHES):
            raise RuntimeError(f"dav2_vitl: (global-attention, LayerNorm) launches "
                               f"{eager_launches} eager, {replay_launches} a replay, expected "
                               f"{DAV2_LAUNCHES}")
        if not torch.equal(replay, eager):
            raise RuntimeError(f"dav2_vitl: the replay is {largest_gap(torch, [replay], [eager])}"
                               " from the eager forward")
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                               "configs", "dav2-kitti-vitl-metric.json")) as f:
            ref = depth_anything_reference.DepthAnythingV2(json.load(f)).cuda().eval()
        ref.load_state_dict({k.replace(".gamma", ".weight"): v
                             for k, v in model.state_dict().items()})
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            want = torch.cat([ref(x[i:i + 2], focal[i:i + 2]) for i in range(0, 8, 2)])
            del ref
            with torch.inference_mode():
                full, = model(x, focal)  # f32, through the kernels' f32 forms
        torch.backends.cudnn.allow_tf32 = True
        gaps = {}
        for name, got in (("bfloat16", replay), ("float32", full)):
            gap = (got - want).abs()
            gaps[name] = ((gap / want).mean().item(), gap.max().item())
            if gaps[name][0] > DAV2_GATES[name][0] or gaps[name][1] > DAV2_GATES[name][1]:
                raise RuntimeError(f"dav2_vitl {name} against the f32 reference: (absrel, max m) "
                                   f"{gaps[name]}, gates {DAV2_GATES[name]}")
        absrel, max_m = gaps["bfloat16"]
        del want, full
    print(f"dav2_vitl ({params} parameters) KITTI 352x1216 b8 against the f32 reference: "
          f"(depth absrel, max m) {gaps}; replay bit-equal to eager, "
          f"{replay_launches} (global-attention, LayerNorm) launches a replay; ms a batch eager "
          f"{eager_ms[1]!r}, replay {replay_ms[1]!r} ({8e3 / replay_ms[1]:.1f} img/s); peak "
          f"{peak} bytes ({smi})", flush=True)

    # (c) the eager and the replayed forward profiled at the cell's size.
    profiles = {}
    for i, eager_run in enumerate((True, False, False, True)):
        run = profile_forward.profile_run(model, x, focal, None, eager=eager_run)
        attn = sum(c for k_, c in run["launches"].items() if "global_attn_kernel" in k_)
        norms = sum(c for k_, c in run["launches"].items()
                    if "layer_norm_kernel" in k_ and "vectorized" not in k_)
        if (attn, norms) != DAV2_LAUNCHES:
            raise RuntimeError(f"dav2_vitl {run['forward']} forward: {attn} global-attention "
                               f"and {norms} LayerNorm launches")
        if eager_run and not {"dav2/encoder", "dav2/head"} <= set(run.get("spans_ms", {})):
            raise RuntimeError(f"dav2_vitl eager profile without its spans: {run.get('spans_ms')}")
        profiles[f"{run['forward']} {i}"] = {k_: run[k_] for k_ in (
            "device_ms", "wall_ms", "kernels", "by_kind_ms", "top_kernels_ms")}
        profiles[f"{run['forward']} {i}"]["spans_ms"] = {
            k_: v_ for k_, v_ in run.get("spans_ms", {}).items() if k_.startswith("dav2/")}
    print(f"dav2_vitl profiled b8 352x1216 bf16: {json.dumps(profiles)} ({smi})", flush=True)
    del model, x, x2, eager, replay
    torch.cuda.empty_cache()
    runs = profile_forward.main(["--encoder", "dav2_vitl", "--batches", "8"])
    for run in runs:
        attn = sum(c for k_, c in run["launches"].items() if "global_attn_kernel" in k_)
        if attn != DAV2_LAUNCHES[0] or (run["forward"] == "eager"
                                        and "dav2/encoder" not in run.get("spans_ms", {})):
            raise RuntimeError(f"profile_forward --encoder dav2_vitl: {attn} global-attention "
                               f"launches, spans {run.get('spans_ms')}")
    torch.cuda.empty_cache()

    # (d) cli.test --encoder dav2_vitl over 8 KITTI frames.
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_kitti_frames(os.path.join(tmp, "data"))
        argv = ["--encoder", "dav2_vitl", "--dataset", "kitti", "--max_depth", "80",
                "--do_kb_crop", "--compute_dtype", "bfloat16", "--eval_batch_size", "8",
                "--data_path", os.path.join(tmp, "data"), "--filenames_file", manifest,
                "--model_name", "dav2"]
        os.chdir(tmp)
        try:
            before = launches()
            if cli_test.main(argv) != 0:
                raise RuntimeError("cli.test --encoder dav2_vitl failed")
            torch.cuda.synchronize()
            launched = tuple(a - b_ for a, b_ in zip(launches(), before))
        finally:
            os.chdir(cwd)
        check_pngs(os.path.join(tmp, "result_dav2", "raw"), 8, (352, 1216), np.uint16)
    if launched != DAV2_LAUNCHES:
        raise RuntimeError(f"cli.test --encoder dav2_vitl: (global-attention, LayerNorm) "
                           f"launches {launched}, expected {DAV2_LAUNCHES} (one forward)")
    print(f"cli.test --encoder dav2_vitl --dataset kitti: 8 uint16 pngs of 352x1216, "
          f"{launched} (global-attention, LayerNorm) launches", flush=True)

    # (e) the cell's check of the program and of each planted fault.
    checks = dav2_cell_checks(torch)
    record = {"name": "global_attention", "route": "triton", "source": GLOBAL_ATTN_SOURCE,
              "replaces": None, "launches_per_forward": DAV2_LAUNCHES[0], "calls": calls,
              "model": {"parameters": params, "depth_absrel": absrel, "depth_max_m": max_m,
                        "float32": gaps["float32"],
                        "eager_ms": eager_ms[1], "replay_ms": replay_ms[1], "peak_bytes": peak,
                        "profiles": profiles},
              "cell_checks": checks, "device": smi}
    print(json.dumps({"global_attention": record}))
    return record


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
    from bts_tpu_torch.models import create_model
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
        f32 = model(x, focal)[-1]
        depth = {}
        for dense_impl in ("auto", "eo"):
            model.encoder.dense_impl = dense_impl
            reset_counts()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                depth[dense_impl] = model(x, focal)[-1]
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
                bf16 = model(x.cuda(), focal.cuda())[-1]
                torch.cuda.synchronize()
            tf_launches["bf16 forward nyu 480x640"] = check_counts("TF bf16 forward", 1, "taps")
            diff = (bf16.float().cpu() - got[-1].cpu()).abs().max().item()
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

    phase("11 data parallelism: two gloo ranks on one card, one NCCL rank, cli.train, sharded "
          "forward")
    dp_launches = phase11(torch, Config, parse_args, create_model, create_optimizer, TrainState,
                          make_train_step, cli_train, run_online_eval, load_checkpoint,
                          list_step_checkpoints, smi)

    phase("12 resume on the card, --async_checkpoint")
    resume_launches = phase12(torch, Config, create_model, create_optimizer, TrainState,
                              make_train_step, cli_train, counts, reset_counts, smi)

    phase("13 the benchmark tools: bench, bench --lpg-check, bench_train, bench_zoo, bench_lpg")
    bench_launches = phase13(torch, counts, reset_counts, smi)

    phase("14 rematerialisation: memory and time, equality, the large batch, two ranks")
    remat_launches = phase14(torch, Config, create_model, create_optimizer, TrainState,
                             make_train_step, counts, reset_counts, smi)
    phase("15 the graphed inference forward: replays against eager, launches, new weights, ms")
    phase15(torch, Config, create_model, counts, reset_counts, smi)
    phase("16 NeWCRFs: the window-attention kernel, large07 against its reference, cli.test")
    window_attn, layer_norm = phase16(torch, Config, create_model, smi)
    phase("17 Depth Anything V2: the global-attention kernel, dav2_vitl against its "
          "reference, cli.test, the cell's check and its planted faults")
    global_attn = phase17(torch, Config, create_model, smi)
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
                                if v["taps"] and k.startswith(tf_dtype[name])},
                "dp_launches": {k: v["taps"] for k, v in dp_launches.items()
                                if v["taps"] and k.endswith(f"{name}, {DP_RANKS} replicas")}}
               if impl == "taps" else {}),
            "bench_launches": {k: v[impl] for k, v in bench_launches.items()
                               if v[impl] and name == "bfloat16"},
        }

    print(json.dumps({"kernels": [
        {"name": "lpg_forward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_REPLACES, "out_dtype": "bfloat16", "launches": serving["lpg"],
         "launches_per_forward": serving["lpg"] // forwards, **lpg_record("bfloat16"),
         "bound_by": "bytes", "library_ms": None,
         "float32": lpg_record("float32"), "bare_float32": lpg_record("bare"),
         "train_sites": dict(zip(("ms", "plain_ms", "bound_ms"), lpg_fwd_train)),
         "zoo_launches": {k: v["lpg"] for k, v in zoo_launches.items()},
         "tf_launches": {k: v["lpg"] for k, v in tf_launches.items()},
         "dp_launches": {k: v["lpg"] for k, v in dp_launches.items()},
         "resume_launches": {k: v["lpg"] for k, v in resume_launches.items()},
         "bench_launches": {k: v["lpg"] for k, v in bench_launches.items()},
         "remat_launches": {k: v["lpg"] for k, v in remat_launches.items()}},
        {"name": "lpg_backward", "route": "cuda", "source": LPG_SOURCE,
         "replaces": LPG_BWD_REPLACES, "grad_dtype": "bfloat16",
         "launches": train_path["lpg_backward"], "launches_per_step": 3,
         **lpg_bwd["bfloat16"], "bound_by": "bytes", "library_ms": None,
         "launch_floor_ms": floor, "float32": lpg_bwd["float32"],
         "zoo_launches": {k: v["lpg_backward"] for k, v in zoo_launches.items()
                          if v["lpg_backward"]},
         "tf_launches": {k: v["lpg_backward"] for k, v in tf_launches.items()
                         if v["lpg_backward"]},
         "dp_launches": {k: v["lpg_backward"] for k, v in dp_launches.items()
                         if v["lpg_backward"]},
         "resume_launches": {k: v["lpg_backward"] for k, v in resume_launches.items()},
         "bench_launches": {k: v["lpg_backward"] for k, v in bench_launches.items()
                            if v["lpg_backward"]},
         "remat_launches": {k: v["lpg_backward"] for k, v in remat_launches.items()
                            if v["lpg_backward"]}},
        dense_record("taps", "bfloat16", serving, forwards),
        dense_record("taps", "float32", f32_path["taps"], 1),
        dense_record("eo", "bfloat16", eo_path, 1),
        dense_record("eo", "float32", f32_path["eo"], 1),
        window_attn,
        layer_norm,
        global_attn,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
