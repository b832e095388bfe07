"""Host-side eval preprocessing: the eval half of ``bts_tpu/data/transforms.py``.

The reference eval/test pipeline (pytorch/bts_dataloader.py:140-180):
decode, /255, depth /1000 (NYU) or /256 (KITTI), the KITTI benchmark crop
when asked, then the input normalisation. The training augmentations come
with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# TF caffe-style normalization kept for TF-checkpoint compat
# (tensorflow/bts_dataloader.py:148-153): x*255 - mean, then *0.017 for
# densenet encoders.
CAFFE_MEAN = np.array([123.68, 116.78, 103.94], dtype=np.float32)
CAFFE_SCALE = 0.017


def kb_crop_box(height: int, width: int) -> Tuple[int, int, int, int]:
    """KITTI benchmark crop: bottom-center 1216x352
    (pytorch/bts_dataloader.py:109-115). Returns (left, top, right, bottom).
    """
    top = int(height - 352)
    left = int((width - 1216) / 2)
    return (left, top, left + 1216, top + 352)


def apply_kb_crop_array(arr: np.ndarray) -> np.ndarray:
    left, top, right, bottom = kb_crop_box(arr.shape[0], arr.shape[1])
    return arr[top:bottom, left:right]


def normalize_image(image: np.ndarray, style: str = "imagenet") -> np.ndarray:
    """Normalize an HWC float image in [0,1].

    'imagenet': torchvision convention (pytorch/bts_dataloader.py:244).
    'caffe': TF convention (tensorflow/bts_dataloader.py:148-153).
    'caffe_unscaled': the TF convention for non-densenet encoders, mean
    subtraction only (tensorflow/bts_dataloader.py:151-153).
    """
    if style == "imagenet":
        return (image - IMAGENET_MEAN) / IMAGENET_STD
    if style == "caffe":
        return (image * 255.0 - CAFFE_MEAN) * CAFFE_SCALE
    if style == "caffe_unscaled":
        return image * 255.0 - CAFFE_MEAN
    raise ValueError(style)


def denormalize_image(image: np.ndarray, style: str = "imagenet") -> np.ndarray:
    if style == "imagenet":
        return image * IMAGENET_STD + IMAGENET_MEAN
    if style == "caffe":
        return (image / CAFFE_SCALE + CAFFE_MEAN) / 255.0
    if style == "caffe_unscaled":
        return (image + CAFFE_MEAN) / 255.0
    raise ValueError(style)


def decode_depth_png(depth_raw: np.ndarray, dataset: str) -> np.ndarray:
    """uint16 depth png -> meters: /1000 NYU, /256 KITTI
    (pytorch/bts_dataloader.py:131-134)."""
    depth = depth_raw.astype(np.float32)
    return depth / 1000.0 if dataset == "nyu" else depth / 256.0


def load_eval_sample(
    image_path: str,
    depth_path: Optional[str],
    dataset: str,
    do_kb_crop: bool = False,
    normalization: str = "imagenet",
):
    """Eval/test sample pipeline (pytorch/bts_dataloader.py:140-180).

    Returns (image HWC normed, depth HW1 or None). Missing/unreadable gt ->
    depth None (reference tolerates it, :152-158).
    """
    image = np.asarray(Image.open(image_path), dtype=np.float32) / 255.0
    depth = None
    if depth_path is not None:
        try:
            depth_img = Image.open(depth_path)
            depth = np.asarray(depth_img, dtype=np.float32)[..., None]
            depth = decode_depth_png(depth, dataset)
        except (IOError, OSError):
            depth = None
    if do_kb_crop:
        image = apply_kb_crop_array(image)
        if depth is not None:
            # The reference's online eval crops gt too
            # (pytorch/bts_dataloader.py:174-175).
            depth = apply_kb_crop_array(depth)
    image = normalize_image(image, normalization)
    return image.astype(np.float32), depth
