"""The port's eval metrics, masking protocol, device metrics and PNG eval on
the CPU, against bts_tpu's on the same seeded inputs (as
tests/test_loss_metrics.py, test_hetero_eval.py and test_eval_apps.py hold
bts_tpu's)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.config import Config as JConfig
from bts_tpu.evaluation import device_eval as jdevice
from bts_tpu.evaluation import metrics as jmetrics
from bts_tpu.evaluation import png_eval as jpng
from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation import device_eval, png_eval
from bts_tpu_torch.evaluation.metrics import (
    EVAL_METRICS,
    compute_errors,
    compute_errors_masked,
)
from bts_tpu_torch.evaluation.protocol import clamp_prediction, eval_mask, kb_crop_reembed

from torch_threads import one_thread  # noqa: F401 (fixture)


def test_compute_errors_golden():
    """Hand-computed values on a tiny vector (test_loss_metrics.py's)."""
    gt = np.array([1.0, 2.0, 4.0])
    m = compute_errors(gt, gt.copy())
    np.testing.assert_allclose(m[:6], 0.0, atol=1e-12)
    np.testing.assert_allclose(m[6:], 1.0)
    m2 = compute_errors(gt, np.array([1.3, 2.0, 4.0]))
    assert m2[EVAL_METRICS.index("d1")] == pytest.approx(2.0 / 3.0)
    assert m2[EVAL_METRICS.index("abs_rel")] == pytest.approx(0.3 / 3.0)
    assert m2[EVAL_METRICS.index("rms")] == pytest.approx(np.sqrt(0.09 / 3.0))


@pytest.mark.parametrize("shape", [(3, 24, 24), (2, 64, 96)])
def test_compute_errors_masked_matches_numpy_and_bts_tpu(shape):
    """Per image against the numpy metrics (f32 sums against f64: rtol 2e-4,
    test_loss_metrics.py's bar), and against bts_tpu's f32 version at rtol
    1e-5 (the same f32 terms, summed in another order)."""
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.1, 10, size=shape).astype(np.float32)
    pred = rng.uniform(0.1, 10, size=shape).astype(np.float32)
    mask = gt > 1.0
    got, valid = compute_errors_masked(torch.from_numpy(gt), torch.from_numpy(pred),
                                       torch.from_numpy(mask))
    assert got.shape == (shape[0], 9) and got.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), 1.0)
    for i in range(shape[0]):
        want = compute_errors(gt[i][mask[i]], pred[i][mask[i]])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=2e-4)
    jgot, jvalid = jmetrics.compute_errors_masked(jnp.asarray(gt), jnp.asarray(pred),
                                                  jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_compute_errors_masked_empty_mask_and_constant_error():
    """An empty mask gives zeros and valid 0, all finite; a constant log error
    keeps silog at 0 (the max(., 0) under its square root), not nan."""
    gt = torch.rand(2, 8, 8) * 9 + 0.5
    mask = torch.zeros(2, 8, 8, dtype=torch.bool)
    mask[1, :4] = True
    got, valid = compute_errors_masked(gt, gt * 1.1, mask)
    assert valid.tolist() == [0.0, 1.0]
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    assert got[1, EVAL_METRICS.index("silog")] < 1e-2
    assert got[1, EVAL_METRICS.index("d1")] == 1.0


@pytest.mark.parametrize("min_d,max_d", [(1e-3, 80.0), (1e-3, 10.0)])
def test_clamp_prediction(min_d, max_d):
    """Either infinity to max, nan to min, then the range (bts_main.py:275-278)."""
    pred = np.array([[np.inf, np.nan, 0.0001, 100.0, 5.0, -np.inf]], dtype=np.float32)
    np.testing.assert_allclose(clamp_prediction(pred, min_d, max_d),
                               [[max_d, min_d, min_d, max_d, 5.0, max_d]])


def test_eval_mask_crops():
    """NYU eigen's fixed region [45:471, 41:601] and KITTI garg's ratios."""
    nyu = eval_mask(np.full((480, 640), 5.0, np.float32), 1e-3, 10.0, "nyu", eigen_crop=True)
    assert nyu[45, 41] and nyu[470, 600] and not nyu[44, 41] and not nyu[45, 601]
    assert nyu.sum() == (471 - 45) * (601 - 41)
    kitti = eval_mask(np.full((352, 1216), 5.0, np.float32), 1e-3, 80.0, "kitti", garg_crop=True)
    r0, r1 = int(0.40810811 * 352), int(0.99189189 * 352)
    c0, c1 = int(0.03594771 * 1216), int(0.96405229 * 1216)
    assert kitti.sum() == (r1 - r0) * (c1 - c0)


def test_kb_crop_reembed():
    out = kb_crop_reembed(np.ones((352, 1216), np.float32), 375, 1242)
    top, left = 375 - 352, (1242 - 1216) // 2
    assert out.shape == (375, 1242) and out[top, left] == 1.0 and out[top - 1, left] == 0.0
    assert out.sum() == 352 * 1216


# ------------------------------------------------------------ device metrics


def _eval_batch(dataset, b, h, w, seed):
    """Seeded predictions with inf, nan and out-of-range values, and uint16
    gt with zero holes."""
    rng = np.random.default_rng(seed)
    max_d = 10.0 if dataset == "nyu" else 80.0
    pred = rng.uniform(0.05, max_d * 1.2, size=(b, h, w)).astype(np.float32)
    flat = pred.reshape(-1)
    for value in (np.inf, -np.inf, np.nan, 0.0, -1.0, 1e4):
        flat[rng.integers(0, flat.size, 50)] = value
    scale = 1000 if dataset == "nyu" else 256
    gt = rng.integers(1, int(max_d * scale), size=(b, h, w)).astype(np.uint16)
    gt[rng.random((b, h, w)) < 0.3] = 0
    return pred, gt


# bts_tpu's rtol: 1e-5 (the f32 sums in another order), but 1e-4 at 480x640,
# where bts_tpu's own jitted d3 is 7.9e-5 away from the numpy protocol's (the
# port's is 2e-8 away).
@pytest.mark.parametrize("dataset,h,w,crop,jax_rtol", [
    ("nyu", 64, 96, None, 1e-5), ("nyu", 480, 640, "eigen_crop", 1e-4),
    ("kitti", 64, 96, "garg_crop", 1e-5), ("kitti", 96, 128, "eigen_crop", 1e-5),
])
def test_batch_metrics_match_bts_tpu_and_numpy(dataset, h, w, crop, jax_rtol):
    """make_batch_metrics on seeded predictions (inf, nan, out of range) and
    gt with holes, one weight-0 image: against bts_tpu's jitted version on the
    same inputs at ``jax_rtol``, and against the numpy protocol per image at
    rtol 1e-4, atol 1e-5 (test_eval_apps.py's bar between f32 device sums and
    the f64 host path). The readback is 9 sums and a count."""
    max_d = 10.0 if dataset == "nyu" else 80.0
    kw = dict(dataset=dataset, min_depth_eval=1e-3, max_depth_eval=max_d,
              **({crop: True} if crop else {}))
    pred, gt = _eval_batch(dataset, 3, h, w, seed=h)
    weights = np.array([1.0, 0.0, 1.0], np.float32)
    sums, count = device_eval.make_batch_metrics(Config(**kw))(torch.from_numpy(pred), gt, weights)
    assert sums.shape == (9,) and sums.dtype == np.float64 and count == 2.0
    jsums, jcount = jdevice.make_batch_metrics(JConfig(**kw))(jnp.asarray(pred), jnp.asarray(gt),
                                                             jnp.asarray(weights))
    np.testing.assert_allclose(sums, np.asarray(jsums), rtol=jax_rtol, atol=1e-7)
    assert count == float(jcount)

    from bts_tpu_torch.evaluation.protocol import prepare_pred_gt

    scale = device_eval.gt_scale(dataset)
    want = np.zeros(9)
    for i in (0, 2):
        p, g, m = prepare_pred_gt(pred[i], gt[i].astype(np.float32) / scale, 1e-3, max_d,
                                  dataset, **({crop: True} if crop else {}))
        want += compute_errors(g[m], p[m])
    np.testing.assert_allclose(sums / count, want / 2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_upload_gt_is_the_numpy_division_bit_for_bit(dataset):
    """Every uint16 value, including those above int16's range."""
    raw = np.arange(65536, dtype=np.uint16).reshape(4, 128, 128)
    got = device_eval.upload_gt(raw, dataset, torch.device("cpu"))
    want = raw.astype(np.float32) / np.float32(device_eval.gt_scale(dataset))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_pack_gt_batch_warns_on_mismatch():
    """test_hetero_eval.py's cases."""
    good = np.full((8, 12, 1), 3.0, np.float32)
    bad = np.full((6, 10, 1), 3.0, np.float32)
    with pytest.warns(UserWarning, match="cannot ride the batched"):
        raw, eff, mismatched = device_eval.pack_gt_batch([good, bad, good], [1.0, 1.0, 1.0],
                                                         "nyu", pred_shape=(8, 12))
    assert raw.shape == (3, 8, 12) and raw.dtype == np.uint16
    np.testing.assert_array_equal(eff, [1.0, 0.0, 1.0])
    assert mismatched == [1]
    raw, eff, mismatched = device_eval.pack_gt_batch([good, None, good], [1.0, 1.0, 1.0], "nyu",
                                                     pred_shape=(8, 12))
    assert mismatched == [] and list(eff) == [1.0, 0.0, 1.0]
    assert device_eval.pack_gt_batch([None], [1.0], "nyu") == (None, None, [])


def test_run_batch_skips_a_batch_without_usable_gt():
    def never(*a):
        raise AssertionError("the device metrics ran")

    preds = torch.ones(2, 8, 12)
    batch = {"depths": [None, None], "weight": np.ones(2, np.float32)}
    assert device_eval.run_batch(never, preds, batch, "nyu") is None
    batch = {"depths": [np.ones((6, 10, 1), np.float32), None], "weight": np.ones(2, np.float32)}
    with pytest.warns(UserWarning):
        sums, count, mismatched = device_eval.run_batch(never, preds, batch, "nyu")
    assert count == 0.0 and mismatched == [0] and not sums.any()


# ------------------------------------------------------------ PNG eval


def _png_set(root, dataset, n=4, h=48, w=80):
    """Prediction pngs named as the dumper names them, and gt pngs where
    gt_path_for_pred looks for them; one prediction without gt."""
    rng = np.random.default_rng(4)
    scale = 1000 if dataset == "nyu" else 256
    preds = root / "raw"
    preds.mkdir(parents=True)
    for i in range(n):
        if dataset == "nyu":
            name, gt = f"kitchen_0001_rgb_{i:05d}.png", root / "gt" / "kitchen_0001" / f"sync_depth_{i:05d}.png"
        else:
            drive = "2011_09_26_drive_0002_sync"
            name = f"{drive}_{i:010d}.png"
            gt = (root / "gt" / "2011_09_26" / drive / "proj_depth/groundtruth/image_02"
                  / f"{i:010d}.png")
        Image.fromarray(rng.integers(0, 12 * scale, (h, w)).astype(np.uint16)).save(preds / name)
        if i != 1:
            gt.parent.mkdir(parents=True, exist_ok=True)
            depth = rng.integers(0, 9 * scale, (h, w)).astype(np.uint16)
            Image.fromarray(depth).save(gt)
    return preds, root / "gt"


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_eval_pngs_matches_bts_tpu(tmp_path, dataset, capsys):
    preds, gt = _png_set(tmp_path, dataset)
    kw = dict(dataset=dataset, pred_path=str(preds), gt_path=str(gt), min_depth_eval=1e-3,
              max_depth_eval=10.0 if dataset == "nyu" else 80.0)
    files = png_eval.collect_pred_files(str(tmp_path))
    assert files == jpng.collect_pred_files(str(tmp_path)) and len(files) == 4
    measures, count = png_eval.eval_pngs(Config(**kw))
    out = capsys.readouterr().out
    jmeasures, jcount = jpng.eval_pngs(JConfig(**kw))
    assert capsys.readouterr().out == out
    assert count == jcount == 3
    np.testing.assert_array_equal(measures, jmeasures)
    assert np.isfinite(measures).all()


def test_gt_path_for_pred():
    cfg = Config(gt_path="/gt")
    assert png_eval.gt_path_for_pred("/x/kitchen_0001_rgb_00003.png", cfg) == os.path.join(
        "/gt", "kitchen_0001", "sync_depth_00003.png")
    assert png_eval.gt_path_for_pred("/x/depth.png", cfg) is None
