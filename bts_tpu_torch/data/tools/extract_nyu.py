"""NYU Depth V2 official-split extraction tool.

The port's copy of ``bts_tpu/data/tools/extract_nyu.py`` (it imports no jax); run it
as ``python -m bts_tpu_torch.data.tools.extract_nyu``.

Capability parity with utils/extract_official_train_test_set_from_mat.py
(reference D5): converts `nyu_depth_v2_labeled.mat` (+ `splits.mat`) into

    <out>/{train,test}/<scene_type>/rgb_%05d.jpg
    <out>/{train,test}/<scene_type>/sync_depth_%05d.png

matching the reference's exact output contract
(extract_official_train_test_set_from_mat.py:44-95):
  * depth comes from `rawDepths` (the unfilled sensor depth), meters x1000
    as uint16 (":58-59");
  * scene folders are named by `sceneTypes` (e.g. 'bathroom') — this is
    what the official nyudepthv2_test_files_with_gt.txt paths use — not by
    scene instance;
  * the rgb is embedded in a zeroed 480x640 canvas keeping rows [7:474)
    and cols [7:632) (":61-63") — the asymmetric border that hides
    registration artifacts.

Implementation is ours: h5py for the v7.3 .mat (the labeled set), scipy.io
for splits.mat, PIL for output.

Usage:
    python -m bts_tpu_torch.data.tools.extract_nyu \
        nyu_depth_v2_labeled.mat splits.mat ./nyu_depth_v2/official_splits
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image

DEPTH_SCALE = 1000.0  # meters -> uint16 millimeters
ROWS = slice(7, 474)  # kept image region (reference :62)
COLS = slice(7, 632)


def _decode_chars(raw) -> str:
    return "".join(chr(c) for c in np.asarray(raw).ravel())


def extract(labeled_mat: str, splits_mat: str, out_root: str) -> int:
    import h5py
    from scipy.io import loadmat

    splits = loadmat(splits_mat)
    train_idx = set(int(i) for i in np.asarray(splits["trainNdxs"]).ravel())
    test_idx = set(int(i) for i in np.asarray(splits["testNdxs"]).ravel())

    n = 0
    with h5py.File(labeled_mat, "r") as f:
        images = f["images"]  # (N, 3, W, H) in HDF5 order
        depths = f["rawDepths"]  # (N, W, H) — unfilled sensor depth
        scene_refs = f["sceneTypes"][0]
        count = images.shape[0]
        for i in range(count):
            one_based = i + 1
            if one_based in train_idx:
                split = "train"
            elif one_based in test_idx:
                split = "test"
            else:
                raise AssertionError(
                    f"index {one_based} neither in training nor in test set"
                )
            scene = _decode_chars(f[scene_refs[i]][()])
            scene_dir = os.path.join(out_root, split, scene)
            os.makedirs(scene_dir, exist_ok=True)

            # HDF5 stores (3, W, H): transpose to (H, W, 3), then embed in
            # the reference's zeroed 480x640 canvas.
            rgb = np.asarray(images[i]).transpose(2, 1, 0).astype(np.uint8)
            canvas = np.zeros((480, 640, 3), dtype=np.uint8)
            canvas[ROWS, COLS] = rgb[ROWS, COLS]
            Image.fromarray(canvas).save(
                os.path.join(scene_dir, f"rgb_{i:05d}.jpg")
            )

            depth = np.asarray(depths[i]).T  # (H, W) meters
            # Reference does a bare astype; clip first so garbage values
            # can't wrap around (identical for all valid NYU depths <65m).
            depth_mm = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
            Image.fromarray(depth_mm).save(
                os.path.join(scene_dir, f"sync_depth_{i:05d}.png")
            )
            n += 1
    return n


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__)
        return 1
    n = extract(argv[0], argv[1], argv[2])
    print(f"Extracted {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
