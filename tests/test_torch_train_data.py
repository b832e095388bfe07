"""The port's on-device train augmentation against bts_tpu's, on the CPU,
with the same injected AugmentParams (the two packages draw them from
different generators)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.data import device_augment as jaug
from bts_tpu_torch.data import device_augment as aug
from bts_tpu_torch.training import state

from torch_threads import one_thread  # noqa: F401 (fixture)

SRC_H, SRC_W, OUT_H, OUT_W = 27, 35, 16, 24


def _sample(rng, h=SRC_H, w=SRC_W):
    image = rng.random((h, w, 3), dtype=np.float32)
    depth = rng.uniform(0.0, 10.0, (h, w, 1)).astype(np.float32)
    return image, depth


def _params(rng, do_flip, do_photo, angle=0.0):
    return dict(angle_deg=angle, crop_y=int(rng.integers(0, SRC_H - OUT_H + 1)),
                crop_x=int(rng.integers(0, SRC_W - OUT_W + 1)), do_flip=do_flip,
                do_photo=do_photo, gamma=float(np.float32(rng.uniform(0.9, 1.1))),
                brightness=float(np.float32(rng.uniform(0.75, 1.25))),
                colors=[float(c) for c in rng.uniform(0.9, 1.1, 3).astype(np.float32)])


def _both(p):
    """The same draw as the port's AugmentParams and bts_tpu's."""
    jp = jaug.AugmentParams(
        angle_deg=jnp.float32(p["angle_deg"]), crop_y=jnp.int32(p["crop_y"]),
        crop_x=jnp.int32(p["crop_x"]), do_flip=jnp.bool_(p["do_flip"]),
        do_photo=jnp.bool_(p["do_photo"]), gamma=jnp.float32(p["gamma"]),
        brightness=jnp.float32(p["brightness"]), colors=jnp.asarray(p["colors"], jnp.float32))
    return aug.AugmentParams(**p), jp


@pytest.mark.parametrize("normalization", ["imagenet", "caffe", "caffe_unscaled"])
@pytest.mark.parametrize("do_flip,do_photo", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_apply_augment_matches(normalization, do_flip, do_photo):
    rng = np.random.default_rng(
        ["imagenet", "caffe", "caffe_unscaled"].index(normalization) * 4 + 2 * do_flip + do_photo)
    image, depth = _sample(rng)
    p, jp = _both(_params(rng, do_flip, do_photo))
    got = aug.apply_augment(torch.from_numpy(image), torch.from_numpy(depth), p, OUT_H, OUT_W,
                            skip_rotate=True, normalization=normalization)
    want = jaug.apply_augment(jnp.asarray(image), jnp.asarray(depth), jp, OUT_H, OUT_W,
                              skip_rotate=True, normalization=normalization)
    assert got[0].shape == (OUT_H, OUT_W, 3) and got[1].shape == (OUT_H, OUT_W, 1)
    # 1e-6 in the image's [0, 1] units, scaled as the normalization scales
    # them (x255 for caffe_unscaled): pow rounds differently in XLA and PyTorch.
    units = {"imagenet": 1 / 0.225, "caffe": 255 * 0.017, "caffe_unscaled": 255.0}[normalization]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6 * units)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("angle", [-2.5, 1.7, 30.0])
def test_rotation_matches_away_from_the_border(angle):
    """Bilinear image and nearest depth, zero fill: 1e-4 away from a
    1-pixel border, where a tap's validity may flip with the f32 rounding of
    its coordinate."""
    rng = np.random.default_rng(int(angle * 10) + 100)
    image, depth = _sample(rng)
    p, jp = _both({**_params(rng, False, False, angle), "crop_y": 0, "crop_x": 0})
    got = aug.apply_augment(torch.from_numpy(image), torch.from_numpy(depth), p, SRC_H, SRC_W,
                            normalization="imagenet")
    want = jaug.apply_augment(jnp.asarray(image), jnp.asarray(depth), jp, SRC_H, SRC_W,
                              normalization="imagenet")
    inner = (slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(got[0].numpy()[inner], np.asarray(want[0])[inner], atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[inner], np.asarray(want[1])[inner], atol=1e-4)
    for order, arr in ((1, image), (0, depth)):
        np.testing.assert_allclose(
            aug.rotate_image(torch.from_numpy(arr), angle, order).numpy()[inner],
            np.asarray(jaug.rotate_image(jnp.asarray(arr), jnp.float32(angle), order))[inner],
            atol=1e-4)


def test_sample_params_ranges_and_determinism():
    draws = [aug.sample_params(torch.Generator().manual_seed(s), SRC_H, SRC_W, OUT_H, OUT_W,
                               2.5, "nyu", True) for s in range(200)]
    assert all(abs(d.angle_deg) <= 2.5 and 0 <= d.crop_y <= SRC_H - OUT_H
               and 0 <= d.crop_x <= SRC_W - OUT_W and 0.9 <= d.gamma <= 1.1
               and 0.75 <= d.brightness <= 1.25 and all(0.9 <= c <= 1.1 for c in d.colors)
               for d in draws)
    assert {d.do_flip for d in draws} == {d.do_photo for d in draws} == {True, False}
    kitti = aug.sample_params(torch.Generator().manual_seed(0), SRC_H, SRC_W, OUT_H, OUT_W, 2.5,
                              "kitti", False)
    assert kitti.angle_deg == 0.0 and 0.9 <= kitti.brightness <= 1.1
    assert aug.sample_params(torch.Generator().manual_seed(3), SRC_H, SRC_W, OUT_H, OUT_W, 2.5,
                             "nyu", True) == draws[3]


def test_augment_batch_is_per_sample_and_deterministic_per_step():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(np.stack([_sample(rng)[0] for _ in range(3)]))
    depths = torch.from_numpy(rng.uniform(0, 10, (3, SRC_H, SRC_W, 1)).astype(np.float32))
    run = lambda seed, step: aug.augment_batch(  # noqa: E731
        state.augment_generator(seed, step), images, depths, OUT_H, OUT_W,
        do_random_rotate=False)
    a, b, c = run(42, 7), run(42, 7), run(42, 8)
    assert a[0].shape == (3, OUT_H, OUT_W, 3) and a[1].shape == (3, OUT_H, OUT_W, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    gen = state.augment_generator(42, 7)
    for i in range(3):
        p = aug.sample_params(gen, SRC_H, SRC_W, OUT_H, OUT_W, 2.5, "nyu", False)
        want = aug.apply_augment(images[i], depths[i], p, OUT_H, OUT_W, skip_rotate=True)
        assert torch.equal(a[0][i], want[0]) and torch.equal(a[1][i], want[1])
