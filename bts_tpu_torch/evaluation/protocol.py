"""Evaluation masking / cropping protocol: ``bts_tpu/evaluation/protocol.py``,
with the crop rectangle in ``crop_mask``, which the device metrics share.

Reference: pytorch/bts_main.py:267-295, pytorch/bts_eval.py:261-289,
utils/eval_with_pngs.py:177-207 — prediction clamping, validity mask, the
garg / eigen crops, and kb-crop re-embedding.
"""

from __future__ import annotations

import numpy as np


def clamp_prediction(
    pred: np.ndarray, min_depth_eval: float, max_depth_eval: float
) -> np.ndarray:
    """Clamp pred to [min,max]; inf -> max, nan -> min.

    Reference: pytorch/bts_main.py:275-278.
    """
    pred = pred.copy()
    pred[np.isinf(pred)] = max_depth_eval
    pred[np.isnan(pred)] = min_depth_eval
    pred[pred < min_depth_eval] = min_depth_eval
    pred[pred > max_depth_eval] = max_depth_eval
    return pred


def kb_crop_reembed(pred: np.ndarray, gt_height: int, gt_width: int) -> np.ndarray:
    """Re-embed a 1216x352 kb-cropped prediction into a full-size zero canvas.

    Reference: pytorch/bts_main.py:267-273.
    """
    top_margin = int(gt_height - 352)
    left_margin = int((gt_width - 1216) / 2)
    out = np.zeros((gt_height, gt_width), dtype=np.float32)
    out[top_margin : top_margin + 352, left_margin : left_margin + 1216] = pred
    return out


def crop_mask(h: int, w: int, dataset: str = "nyu", garg_crop: bool = False,
              eigen_crop: bool = False) -> np.ndarray:
    """The static crop rectangle of an (h, w) gt, all True without a crop.

    Reference: pytorch/bts_main.py:282-295. NYU eigen_crop is the fixed
    region [45:471, 41:601]; KITTI crops are ratios of gt size.
    """
    m = np.zeros((h, w), dtype=bool)
    if garg_crop:
        m[int(0.40810811 * h) : int(0.99189189 * h), int(0.03594771 * w) : int(0.96405229 * w)] = True
    elif eigen_crop:
        if dataset == "kitti":
            m[int(0.3324324 * h) : int(0.91351351 * h), int(0.0359477 * w) : int(0.96405229 * w)] = True
        else:
            m[45:471, 41:601] = True
    else:
        m[:] = True
    return m


def eval_mask(
    gt: np.ndarray,
    min_depth_eval: float,
    max_depth_eval: float,
    dataset: str = "nyu",
    garg_crop: bool = False,
    eigen_crop: bool = False,
) -> np.ndarray:
    """Validity mask: gt in (min, max), intersected with the chosen crop
    (pytorch/bts_main.py:280-295)."""
    valid = np.logical_and(gt > min_depth_eval, gt < max_depth_eval)
    return np.logical_and(valid, crop_mask(*gt.shape, dataset, garg_crop, eigen_crop))


def prepare_pred_gt(
    pred: np.ndarray,
    gt: np.ndarray,
    min_depth_eval: float,
    max_depth_eval: float,
    dataset: str = "nyu",
    do_kb_crop: bool = False,
    garg_crop: bool = False,
    eigen_crop: bool = False,
):
    """Full protocol: kb re-embed -> clamp -> mask. Returns (pred, gt, mask)."""
    pred = np.asarray(pred, dtype=np.float32).squeeze()
    gt = np.asarray(gt, dtype=np.float32).squeeze()
    if do_kb_crop and pred.shape != gt.shape:
        pred = kb_crop_reembed(pred, gt.shape[0], gt.shape[1])
    pred = clamp_prediction(pred, min_depth_eval, max_depth_eval)
    mask = eval_mask(
        gt, min_depth_eval, max_depth_eval, dataset, garg_crop, eigen_crop
    )
    return pred, gt, mask
