"""PNG-vs-PNG evaluator, the canonical metric path: a copy of
``bts_tpu/evaluation/png_eval.py``.

Reference: utils/eval_with_pngs.py:74-217 — walks a prediction directory,
reconstructs gt paths from filenames (KITTI 'proj_depth/groundtruth/image_02',
NYU 'sync_depth_*'), applies the eval protocol, prints the nine-metric table.
These are the numbers quoted in the reference READMEs (BASELINE.md).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from bts_tpu_torch.config import Config
from bts_tpu_torch.evaluation.metrics import EVAL_METRICS, compute_errors
from bts_tpu_torch.evaluation.protocol import clamp_prediction, eval_mask, kb_crop_reembed


def _read_depth_png(path: str, dataset: str) -> Optional[np.ndarray]:
    try:
        arr = np.asarray(Image.open(path), dtype=np.float32)
    except (IOError, OSError):
        return None
    return arr / 1000.0 if dataset == "nyu" else arr / 256.0


def collect_pred_files(pred_path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(pred_path, "*.png")))
    if not files:
        files = sorted(glob.glob(os.path.join(pred_path, "raw", "*.png")))
    return files


def gt_path_for_pred(pred_file: str, cfg: Config) -> Optional[str]:
    """Reconstruct the gt path from a prediction filename
    (utils/eval_with_pngs.py:93-119 filename conventions)."""
    name = os.path.basename(pred_file)
    if cfg.dataset == "kitti":
        # '<date>_<drive>_<...>_<image>.png' with drive folder encoded by
        # the dumper as '<drive>_<filename>'.
        parts = name.split("_")
        if len(parts) < 2:
            return None
        drive = "_".join(parts[:-1])
        filename = parts[-1]
        date = "_".join(parts[:3]) if len(parts) >= 3 else ""
        return os.path.join(
            cfg.gt_path, date, drive, "proj_depth/groundtruth/image_02", filename
        )
    # NYU: '<scene>_rgb_<idx>.jpg' dumped as '<scene>_rgb_<idx>.png';
    # gt lives at '<scene>/sync_depth_<idx>.png'.
    if "_rgb_" in name:
        scene, idx = name.rsplit("_rgb_", 1)
        idx = idx.replace(".png", "").replace(".jpg", "")
        return os.path.join(cfg.gt_path, scene, f"sync_depth_{idx}.png")
    return None


def eval_pngs(
    cfg: Config,
    pred_files: Optional[List[str]] = None,
    gt_files: Optional[List[str]] = None,
    verbose: bool = True,
) -> Tuple[np.ndarray, int]:
    """Evaluate predictions against gt pngs. Returns (mean metrics, count).

    If gt_files is None, gt paths are reconstructed from pred filenames.
    Missing gt files are skipped (utils/eval_with_pngs.py:115-119).
    """
    if pred_files is None:
        pred_files = collect_pred_files(cfg.pred_path)
    sums = np.zeros(9, dtype=np.float64)
    count = 0
    for i, pf in enumerate(pred_files):
        pred = _read_depth_png(pf, cfg.dataset)
        if pred is None:
            continue
        gt_file = gt_files[i] if gt_files else gt_path_for_pred(pf, cfg)
        if gt_file is None or not os.path.exists(gt_file):
            continue
        gt = _read_depth_png(gt_file, cfg.dataset)
        if gt is None:
            continue
        if cfg.do_kb_crop and pred.shape != gt.shape:
            pred = kb_crop_reembed(pred, gt.shape[0], gt.shape[1])
        if pred.shape != gt.shape:
            continue
        pred = clamp_prediction(pred, cfg.min_depth_eval, cfg.max_depth_eval)
        mask = eval_mask(
            gt,
            cfg.min_depth_eval,
            cfg.max_depth_eval,
            cfg.dataset,
            cfg.garg_crop,
            cfg.eigen_crop,
        )
        if not mask.any():
            continue
        sums += compute_errors(gt[mask], pred[mask])
        count += 1

    measures = sums / max(count, 1)
    if verbose:
        print(f"Computing errors for {count} eval samples")
        print(", ".join(f"{m:>7}" for m in EVAL_METRICS))
        print(", ".join(f"{v:7.3f}" for v in measures))
    return measures, count
