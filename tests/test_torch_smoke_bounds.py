"""chip_smoke.py's work counts and bounds, on the CPU: the DenseNet161 layer
shapes of phase 3 and the least time the card could take for each kernel's
work (the ``bound_ms`` of its JSON line)."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (fixture)

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
    """Phase 7(c) runs the NYU recipe as it is, --do_online_eval and
    --eigen_crop included, with the eval split pointed at the run's frames:
    an eval every 3 steps at batch 4."""
    from bts_tpu_torch.config import parse_args

    data = tmp_path / "d"
    path, overrides = cs.train_args(str(data / "files.txt"), str(data / "eval.txt"),
                                    str(tmp_path / "logs"))
    assert path == os.path.join(ROOT, "configs", "arguments_train_nyu.txt")
    cfg = parse_args(["@" + path, *overrides])
    assert cfg.do_online_eval and cfg.eigen_crop and cfg.device_augment
    assert (cfg.data_path_eval, cfg.gt_path_eval, cfg.filenames_file_eval) == (
        str(data), str(data), str(data / "eval.txt"))
    assert (cfg.eval_freq, cfg.eval_batch_size, cfg.num_epochs) == (cs.EVAL_FREQ, cs.EVAL_BATCH, 1)
    assert (cfg.min_depth_eval, cfg.max_depth_eval, cfg.compute_dtype) == (1e-3, 10.0, "bfloat16")


def test_best_checkpoints_read_the_loops_names(tmp_path):
    """Phase 7(c) finds each metric's best file by the loop's own naming."""
    from bts_tpu_torch.training.checkpoint import best_checkpoint_name

    names = [best_checkpoint_name(3, "silog", 69.963491), best_checkpoint_name(6, "d1", 0.3216),
             best_checkpoint_name(3, "log_rms", 0.82111), best_checkpoint_name(6, "silog", 9.5),
             "model-6", "model-6.123.tmp", "arguments.txt"]
    for name in names:
        (tmp_path / name).write_bytes(b"x")
    best = cs.best_checkpoints(str(tmp_path))
    assert sorted(best) == ["d1", "log_rms", "silog"]
    assert [s for s, _ in best["silog"]] == [3, 6]
    assert best["log_rms"] == [(3, str(tmp_path / "model-3-best_log_rms_0.82111"))]


def test_eval_throughput_times_a_split_the_size_of_nyus(tmp_path):
    """Phase 8(d) warms up on the given frames, then times four evals and the
    loader over NYU_TEST_FRAMES lines (the NYU eval split's count), each
    frame counted once."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.data.loader import EvalLoader

    with open(os.path.join(ROOT, "train_test_inputs", "nyudepthv2_test_files_with_gt.txt")) as f:
        assert sum(1 for _ in f) == cs.NYU_TEST_FRAMES
    manifest = cs.write_nyu_frames(str(tmp_path), n=3, h=24, w=32)
    cfg = Config(dataset="nyu", data_path_eval=str(tmp_path), gt_path_eval=str(tmp_path),
                 min_depth_eval=1e-3, max_depth_eval=10.0, device_eval=True)
    seen = []

    def run_online_eval(model, cfg, verbose):
        with open(cfg.filenames_file_eval) as f:
            seen.append((len(f.readlines()), cfg.device_eval, cfg.eval_batch_size,
                         cfg.compute_dtype))
        return np.ones(9)

    rates, info = cs.eval_throughput(None, cfg, manifest, run_online_eval, EvalLoader)
    n = cs.NYU_TEST_FRAMES
    assert seen == [(3, True, 8, "bfloat16"), (n, True, 8, "bfloat16"), (n, False, 8, "bfloat16"),
                    (n, False, 8, "bfloat16"), (n, True, 8, "bfloat16")]
    assert sorted(rates) == ["device_eval_off", "device_eval_on", "loader_only"]
    assert (info["frames"], info["distinct_frames"], len(info["runs"])) == (n, 3, 4)
    assert info["loader_share_of_eval_wall"] == rates["device_eval_on"] / rates["loader_only"]


def test_phase11_rank_shares_make_the_global_batch():
    """Phase 11's ranks take contiguous shares of its global batch in rank
    order (parallel.mesh.local_slice), which together are the batch the
    single-process step takes."""
    from bts_tpu_torch.parallel.mesh import local_slice

    batch = {"focal": np.arange(cs.DP_BATCH)}
    shares = [local_slice(batch, cs.DP_RANKS, r)["focal"] for r in range(cs.DP_RANKS)]
    assert [s.tolist() for s in shares] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="a batch of 4 does not split over 3 ranks"):
        local_slice(batch, 3, 0)


@pytest.mark.parametrize("kw,want", [
    (dict(steps=1), {"taps": 0, "eo": 0, "lpg": 3, "lpg_backward": 3}),
    (dict(steps=2), {"taps": 0, "eo": 0, "lpg": 6, "lpg_backward": 6}),
    (dict(forwards=1, replicas=2), {"taps": 156, "eo": 0, "lpg": 6, "lpg_backward": 0}),
])
def test_phase11_launch_accounting(kw, want):
    """A train step launches 3 LPG forward and 3 backward and no fused dense
    kernel; each replica's inference forward 78 taps (DenseNet161) and 3 LPG."""
    assert cs.dp_expected_launches(**kw) == want


def test_phase16_norms_are_large07s():
    """NEWCRFS_NORMS holds each LayerNorm of ``large07`` once, by its width
    and the dtype it writes under autocast (``to_gemm``), at the rows of a
    stage's token grid at batch 8 and 480x640."""
    import collections

    import torch

    from bts_tpu_torch.models import layers, newcrfs

    with torch.device("meta"):
        model = newcrfs.NeWCRFsModel(10.0, **newcrfs.VERSIONS["large07"])
    want = collections.Counter(
        (m.normalized_shape[0], "bfloat16" if m.to_gemm else "float32")
        for m in model.modules() if isinstance(m, layers.LayerNorm))
    got = collections.Counter()
    for _, rows, c, _, out, n in cs.NEWCRFS_NORMS:
        got[c, out] += n
        assert rows in [8 * 120 * 160 // 4 ** k for k in range(4)]
    assert got == want
    assert sum(want.values()) == cs.NEWCRFS_NORM_LAUNCHES == 76


def test_phase17_launches_are_dav2s():
    """DAV2_LAUNCHES holds ``dav2_vitl``'s global attentions (one a block up
    to the last tap), LayerNorms (two a block and one a tap) and bilinear
    resizes (one a fusion block, output_conv1's and the depth's), and
    DAV2_SHAPE its call at the KITTI cell's batch 8 and 352x1216."""
    import torch

    from bts_tpu_torch.models import depth_anything, layers
    from bts_tpu_torch.models.encoders import vit

    with torch.device("meta"):
        model = depth_anything.DepthAnythingV2Model(80.0, **depth_anything.VERSIONS["dav2_vitl"])
    blocks = max(model.pretrained.taps) + 1
    norms = sum(isinstance(m, layers.LayerNorm) for m in model.pretrained.blocks[:blocks].modules())
    fusions = sum(isinstance(m, depth_anything.FeatureFusionBlock) for m in model.modules())
    assert cs.DAV2_LAUNCHES == (blocks, norms + len(model.pretrained.taps), fusions + 2) == (
        24, 52, 6)
    mh, mw = depth_anything.model_input(352, 1216, model.input_size)
    assert cs.DAV2_SHAPE == (8, 16, (mh // vit.PATCH) * (mw // vit.PATCH) + 1, 64)


def test_phase18_resizes_are_the_models():
    """RESIZE_HEAD holds the DPT head's five resizes at the KITTI cell's
    frame: each fusion level's map (the fourth tap's halved by a stride-2
    convolution, the third's as it is, the second's and the first's
    enlarged by their transposed convolutions' strides) to the next one's
    size, the first x2, then output_conv1's half width to the model input;
    the PSP calls are ``large07``'s pool scales to the 480x640 frame's
    1/32 grid; the launches a forward match phases 16 and 17."""
    from bts_tpu_torch.models import depth_anything, newcrfs
    from bts_tpu_torch.models.encoders import vit

    version = depth_anything.VERSIONS["dav2_vitl"]
    mh, mw = depth_anything.model_input(352, 1216, version["input_size"])
    h, w = mh // vit.PATCH, mw // vit.PATCH
    grids = [(4 * h, 4 * w), (2 * h, 2 * w), (h, w), ((h + 1) // 2, (w + 1) // 2)]
    head = [(grids[i + 1], grids[i]) for i in (2, 1, 0)] + [(grids[0], (8 * h, 8 * w)),
                                                            ((8 * h, 8 * w), (mh, mw))]
    features = version["features"]
    assert [(c, (hi, wi), (ho, wo)) for _, c, hi, wi, ho, wo in cs.RESIZE_HEAD] == [
        (c, *sizes) for c, sizes in zip([features] * 4 + [features // 2], head)]
    psp = [call for call in cs.RESIZE_CALLS if call[0].startswith("psp")]
    channels = newcrfs.VERSIONS["large07"]["psp_channels"]
    assert [call[1:6] for call in psp] == [(channels, s, s, 480 // 32, 640 // 32)
                                           for s in newcrfs.POOL_SCALES]
    assert cs.RESIZE_LAUNCHES == {"dav2_vitl": 6, "large07": len(psp) + 1}


def test_phase19_launches_are_marigolds():
    """MARIGOLD_LAUNCHES holds ``marigold_v1_0``'s global attentions (two a
    Transformer block), LayerNorms (three a block) a U-Net call times its 10
    calls, and the frame's one resize; MARIGOLD_ATTN the U-Net's attention
    calls at NYU 480x640 (processed at 576x768, a 72x96 latent) and batch 8,
    by level, their launches a call summing to the blocks' self- and
    cross-attentions; MARIGOLD_NORMS the U-Net's LayerNorms by (rows, C) at
    batch 8, each writing the dtype its Linear reads, three a Transformer
    block at its level's tokens over the 10 calls; MARIGOLD_RESIZE the
    frame's float32 NCHW map to the processing size, without corners; the
    cell's known misses planted faults of ``tests/test_torch_marigold.py``."""
    import collections

    import torch

    from bts_tpu_torch.models import layers, marigold

    with torch.device("meta"):
        model = marigold.MarigoldModel(**marigold.VERSIONS["marigold_v1_0"])
    steps = model.steps
    blocks = [m for m in model.unet.modules() if isinstance(m, marigold.TransformerBlock)]
    norms = sum(isinstance(m, layers.LayerNorm) for m in model.unet.modules())
    assert cs.MARIGOLD_UNET_CALLS == steps == 10
    assert cs.MARIGOLD_LAUNCHES == (2 * len(blocks) * steps, norms * steps, 1) == (320, 480, 1)
    ph, pw = marigold.processing_size(480, 640, model.processing_res)
    lh, lw = ph // 8, pw // 8
    assert (lh, lw) == (72, 96)
    by_width = {}
    for m in model.unet.modules():
        if isinstance(m, marigold.Transformer2D):
            by_width[m.proj_in.in_features] = by_width.get(m.proj_in.in_features, 0) + 1
    want = []
    for level, (c, n) in enumerate(((320, 5), (640, 5), (1280, 5), (1280, 1))):
        tokens = (lh >> level) * (lw >> level)
        want += [(c // 64, tokens, tokens, 8, n), (c // 64, tokens, 77, 1, n)]
    assert cs.MARIGOLD_ATTN == want
    assert by_width == {320: 5, 640: 5, 1280: 6}
    assert sum(n for *_, n in cs.MARIGOLD_ATTN) == 2 * len(blocks) == 32

    unet, last = model.unet, len(model.unet.down_blocks) - 1
    placed = ([(level, b.attentions) for level, b in enumerate(unet.down_blocks)]
              + [(last - i, b.attentions) for i, b in enumerate(unet.up_blocks)]
              + [(last, unet.mid_block.attentions)])
    norms_at = collections.Counter()
    for level, attentions in placed:
        for m in attentions.modules() if attentions is not None else ():
            if isinstance(m, layers.LayerNorm):
                assert m.to_gemm
                norms_at[8 * (lh >> level) * (lw >> level), m.normalized_shape[0]] += steps
    assert collections.Counter({(rows, c): n for _, rows, c, i, o, n in cs.MARIGOLD_NORMS
                                if (i, o) == ("bfloat16", "bfloat16")}) == norms_at
    assert len(cs.MARIGOLD_NORMS) == 4 and sum(norms_at.values()) == 480
    assert [call[1:] for call in cs.MARIGOLD_RESIZE] == [
        (3, 480, 640, ph, pw, False, False, "float32", out) for out in ("bfloat16", "float32")]
    assert len(cs.MARIGOLD_RESIZE) // 2 == cs.MARIGOLD_LAUNCHES[2]

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_marigold

    assert set(cs.MARIGOLD_CELL_MISSES) < set(test_torch_marigold.FAULTS)
