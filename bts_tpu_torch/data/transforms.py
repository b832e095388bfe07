"""Host-side image preprocessing: a copy of ``bts_tpu/data/transforms.py``.

Eval/test (pytorch/bts_dataloader.py:140-180): decode, /255, depth /1000
(NYU) or /256 (KITTI), the KITTI benchmark crop when asked, then the input
normalisation.

Train (pytorch/bts_dataloader.py:94-235): [use_right swap] -> kb_crop ->
NYU border crop (43,45,608,472) -> random rotate +-degree (bilinear image,
nearest depth) -> /255, depth /1000 or /256 -> random crop (h, w) -> random
h-flip p=0.5 -> photometric augment p=0.5 -> normalize. In raw mode
(``load_raw_train_sample``, under ``--device_augment``) the host stops after
the rotation and the rest runs on the card (``data/device_augment.py``).

All randomness flows through an explicit numpy Generator, so the same
Generator gives the same arrays as ``bts_tpu``'s.
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

NYU_BORDER_CROP = (43, 45, 608, 472)  # left, top, right, bottom


def kb_crop_box(height: int, width: int) -> Tuple[int, int, int, int]:
    """KITTI benchmark crop: bottom-center 1216x352
    (pytorch/bts_dataloader.py:109-115). Returns (left, top, right, bottom).
    """
    top = int(height - 352)
    left = int((width - 1216) / 2)
    return (left, top, left + 1216, top + 352)


def apply_kb_crop(img: Image.Image) -> Image.Image:
    return img.crop(kb_crop_box(img.height, img.width))


def apply_kb_crop_array(arr: np.ndarray) -> np.ndarray:
    left, top, right, bottom = kb_crop_box(arr.shape[0], arr.shape[1])
    return arr[top:bottom, left:right]


def rotate_pair(
    image: Image.Image, depth: Image.Image, angle: float
) -> Tuple[Image.Image, Image.Image]:
    """PIL rotate: bilinear for image, nearest for depth
    (pytorch/bts_dataloader.py:122-125,187-189)."""
    return (
        image.rotate(angle, resample=Image.BILINEAR),
        depth.rotate(angle, resample=Image.NEAREST),
    )


def random_crop(
    img: np.ndarray, depth: np.ndarray, height: int, width: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference random_crop (pytorch/bts_dataloader.py:191-200)."""
    if img.shape[0] < height or img.shape[1] < width:
        raise ValueError(f"random_crop: image {img.shape[:2]} smaller than {(height, width)}")
    x = int(rng.integers(0, img.shape[1] - width + 1))
    y = int(rng.integers(0, img.shape[0] - height + 1))
    return img[y:y + height, x:x + width, :], depth[y:y + height, x:x + width, :]


def augment_image(image: np.ndarray, dataset: str, rng: np.random.Generator) -> np.ndarray:
    """Photometric augment (pytorch/bts_dataloader.py:216-235)."""
    gamma = rng.uniform(0.9, 1.1)
    image_aug = image**gamma
    brightness = rng.uniform(0.75, 1.25) if dataset == "nyu" else rng.uniform(0.9, 1.1)
    image_aug = image_aug * brightness
    colors = rng.uniform(0.9, 1.1, size=3).astype(np.float32)
    image_aug = image_aug * colors[None, None, :]
    return np.clip(image_aug, 0, 1)


def train_preprocess(
    image: np.ndarray, depth_gt: np.ndarray, dataset: str, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Random flip + photometric augment (pytorch/bts_dataloader.py:202-214)."""
    if rng.random() > 0.5:
        image = image[:, ::-1, :].copy()
        depth_gt = depth_gt[:, ::-1, :].copy()
    if rng.random() > 0.5:
        image = augment_image(image, dataset, rng)
    return image, depth_gt


def normalize_image(image: np.ndarray, style: str = "imagenet") -> np.ndarray:
    """Normalize an HWC float image in [0,1].

    'imagenet': torchvision convention (pytorch/bts_dataloader.py:244).
    'caffe': TF convention (tensorflow/bts_dataloader.py:148-153).
    'caffe_unscaled': the TF convention for non-densenet encoders, mean
    subtraction only (tensorflow/bts_dataloader.py:151-153).
    'symmetric': RGB in [-1, 1], Marigold's rgb / 255 * 2 - 1.
    """
    if style == "imagenet":
        return (image - IMAGENET_MEAN) / IMAGENET_STD
    if style == "symmetric":
        return image * 2.0 - 1.0
    if style == "caffe":
        return (image * 255.0 - CAFFE_MEAN) * CAFFE_SCALE
    if style == "caffe_unscaled":
        return image * 255.0 - CAFFE_MEAN
    raise ValueError(style)


def denormalize_image(image: np.ndarray, style: str = "imagenet") -> np.ndarray:
    if style == "imagenet":
        return image * IMAGENET_STD + IMAGENET_MEAN
    if style == "symmetric":
        return (image + 1.0) / 2.0
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


def _open_train_pair(image_path, depth_path, dataset, rng, do_kb_crop, do_random_rotate, degree):
    """Decode, the static crops and the host rotation -> (image [0,1] HWC,
    depth in meters HW1), both f32."""
    image = Image.open(image_path)
    depth_gt = Image.open(depth_path)
    if do_kb_crop:
        image = apply_kb_crop(image)
        depth_gt = apply_kb_crop(depth_gt)
    if dataset == "nyu":
        image = image.crop(NYU_BORDER_CROP)
        depth_gt = depth_gt.crop(NYU_BORDER_CROP)
    if do_random_rotate and rng is not None:
        angle = (rng.random() - 0.5) * 2 * degree
        image, depth_gt = rotate_pair(image, depth_gt, angle)
    image = np.asarray(image, dtype=np.float32) / 255.0
    depth = decode_depth_png(np.asarray(depth_gt, dtype=np.float32)[..., None], dataset)
    return image, depth


def load_train_sample(
    image_path: str,
    depth_path: str,
    dataset: str,
    input_height: int,
    input_width: int,
    rng: np.random.Generator,
    do_kb_crop: bool = False,
    do_random_rotate: bool = False,
    degree: float = 2.5,
    normalization: str = "imagenet",
) -> Tuple[np.ndarray, np.ndarray]:
    """Full reference train-sample pipeline -> (image HWC normed, depth HW1)."""
    image, depth = _open_train_pair(image_path, depth_path, dataset, rng, do_kb_crop,
                                    do_random_rotate, degree)
    image, depth = random_crop(image, depth, input_height, input_width, rng)
    image, depth = train_preprocess(image, depth, dataset, rng)
    image = normalize_image(image, normalization)
    return image.astype(np.float32), depth.astype(np.float32)


def load_raw_train_sample(
    image_path: str,
    depth_path: str,
    dataset: str,
    rng: Optional[np.random.Generator] = None,
    do_kb_crop: bool = False,
    do_random_rotate: bool = False,
    degree: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + static crops (+ optional host rotation): the host half of the
    on-device augmentation. Returns the un-normalized image in [0,1] (HWC) and
    depth in meters (HW1)."""
    image, depth = _open_train_pair(image_path, depth_path, dataset, rng, do_kb_crop,
                                    do_random_rotate, degree)
    return image.astype(np.float32), depth.astype(np.float32)
