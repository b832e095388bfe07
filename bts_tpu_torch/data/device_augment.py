"""On-device training augmentation: ``bts_tpu/data/device_augment.py``.

The host decodes and applies the static crops (and, in the train loader's
raw mode, the rotation); random crop, flip, photometric jitter and
normalization run on the card inside the train step, on NHWC tensors:

  * rotation: angle ~ U(-degree, degree), bilinear for the image and nearest
    for depth, zero fill, same output size (``map_coordinates`` with mode
    ``constant``, as ``bts_tpu`` computes it);
  * random crop to (input_height, input_width) (pytorch/bts_dataloader.py:191-200);
  * horizontal flip with p=0.5 (:202-207);
  * photometric with p=0.5: gamma U(0.9,1.1), brightness U(0.75,1.25) NYU /
    U(0.9,1.1) KITTI, per-channel color U(0.9,1.1), clip [0,1] (:216-235);
  * normalization: imagenet, caffe, caffe_unscaled or symmetric.

The parameters are drawn on the host from an explicit ``torch.Generator``
(a few scalars per sample), so the step is deterministic per generator seed;
the train step seeds it from (seed, step). The values differ from
``jax.random``'s: the tests inject the same ``AugmentParams`` into both.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# TF caffe-style stats (tensorflow/bts_dataloader.py:148-153).
CAFFE_MEAN = (123.68, 116.78, 103.94)
CAFFE_SCALE = 0.017


class AugmentParams(NamedTuple):
    """One sample's draw. Floats are f32 values held as Python floats."""

    angle_deg: float
    crop_y: int
    crop_x: int
    do_flip: bool
    do_photo: bool
    gamma: float
    brightness: float
    colors: Sequence[float]  # 3


def _uniform(gen: torch.Generator, lo: float, hi: float, n: int = 1) -> torch.Tensor:
    return torch.rand(n, generator=gen) * (hi - lo) + lo


def sample_params(
    gen: torch.Generator,
    src_h: int,
    src_w: int,
    out_h: int,
    out_w: int,
    degree: float,
    dataset: str,
    do_random_rotate: bool,
) -> AugmentParams:
    """Draw one sample's parameters from ``gen`` (a CPU generator)."""
    u = torch.rand(3, generator=gen)
    angle = float((u[0] - 0.5) * 2.0 * degree) if do_random_rotate else 0.0
    crop_y = int(torch.randint(0, src_h - out_h + 1, (), generator=gen))
    crop_x = int(torch.randint(0, src_w - out_w + 1, (), generator=gen))
    b_lo, b_hi = (0.75, 1.25) if dataset == "nyu" else (0.9, 1.1)
    return AugmentParams(
        angle_deg=angle,
        crop_y=crop_y,
        crop_x=crop_x,
        do_flip=bool(u[1] > 0.5),
        do_photo=bool(u[2] > 0.5),
        gamma=float(_uniform(gen, 0.9, 1.1)),
        brightness=float(_uniform(gen, b_lo, b_hi)),
        colors=_uniform(gen, 0.9, 1.1, 3).tolist(),
    )


def _round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.sign(x) * ((x - t).abs() >= 0.5)


def rotate_image(img: torch.Tensor, angle_deg: float, order: int) -> torch.Tensor:
    """Rotate (H, W, C) counterclockwise about the center, zero fill: output
    (x, y) samples the input at the inverse rotation about ((w-1)/2, (h-1)/2),
    bilinear (order 1) or nearest (order 0, halves away from zero), each tap
    outside the image counting 0 -- ``map_coordinates(mode='constant')``."""
    h, w, _ = img.shape
    f32 = dict(dtype=torch.float32, device=img.device)
    theta = torch.tensor(angle_deg, **f32) * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    yy, xx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    x0 = xx - (w - 1) / 2.0
    y0 = yy - (h - 1) / 2.0
    src_x = cos * x0 - sin * y0 + (w - 1) / 2.0
    src_y = sin * x0 + cos * y0 + (h - 1) / 2.0

    def taps(coord: torch.Tensor, size: int):
        if order == 0:
            return [(_round_half_away_from_zero(coord).long(), None)]
        lower = torch.floor(coord)
        upper_w = coord - lower
        lower = lower.long()
        return [(lower, 1 - upper_w), (lower + 1, upper_w)]

    out = None
    for iy, wy in taps(src_y, h):
        for ix, wx in taps(src_x, w):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            val = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            val = torch.where(valid[..., None], val, torch.zeros((), **f32))
            term = val if wy is None else (wy * wx)[..., None] * val
            out = term if out is None else out + term
    return out


def normalize(image: torch.Tensor, normalization: str) -> torch.Tensor:
    """HWC or NHWC image in [0, 1] -> the model's input statistics."""
    f32 = dict(dtype=torch.float32, device=image.device)
    if normalization == "caffe":
        return (image * 255.0 - torch.tensor(CAFFE_MEAN, **f32)) * CAFFE_SCALE
    if normalization == "caffe_unscaled":
        # x0.017 is densenet-only in the TF reference
        # (tensorflow/bts_dataloader.py:151-153).
        return image * 255.0 - torch.tensor(CAFFE_MEAN, **f32)
    if normalization == "symmetric":
        return image * 2.0 - 1.0
    return (image - torch.tensor(IMAGENET_MEAN, **f32)) / torch.tensor(IMAGENET_STD, **f32)


def apply_augment(
    image: torch.Tensor,
    depth: torch.Tensor,
    params: AugmentParams,
    out_h: int,
    out_w: int,
    skip_rotate: bool = False,
    normalization: str = "imagenet",
):
    """Deterministic augmentation of one (H, W, C) sample given its params."""
    if not skip_rotate:
        image = rotate_image(image, params.angle_deg, order=1)
        depth = rotate_image(depth, params.angle_deg, order=0)
    y, x = params.crop_y, params.crop_x
    image = image[y:y + out_h, x:x + out_w]
    depth = depth[y:y + out_h, x:x + out_w]
    if params.do_flip:
        image, depth = image.flip(1), depth.flip(1)
    if params.do_photo:
        colors = torch.tensor(params.colors, dtype=torch.float32, device=image.device)
        image = torch.clamp(image**params.gamma * params.brightness * colors, 0.0, 1.0)
    return normalize(image, normalization), depth


def augment_batch(
    gen: torch.Generator,
    images: torch.Tensor,
    depths: torch.Tensor,
    out_h: int,
    out_w: int,
    degree: float = 2.5,
    dataset: str = "nyu",
    do_random_rotate: bool = True,
    normalization: str = "imagenet",
    first: int = 0,
):
    """(B, H, W, 3) raw [0,1] images + (B, H, W, 1) depths -> cropped,
    augmented, normalized (B, out_h, out_w, *), one draw per sample from
    ``gen``. The batch may be a share of a larger (global) batch that starts
    at sample ``first``: the draws of the samples before it are made and
    skipped, so each sample gets the draw it gets in the whole batch."""
    b, src_h, src_w, _ = images.shape
    params = [sample_params(gen, src_h, src_w, out_h, out_w, degree, dataset, do_random_rotate)
              for _ in range(first + b)][first:]
    out = [
        apply_augment(images[i], depths[i], p, out_h, out_w, skip_rotate=not do_random_rotate,
                      normalization=normalization)
        for i, p in enumerate(params)
    ]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
