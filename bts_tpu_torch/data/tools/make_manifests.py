"""Split-manifest generation.

The port's copy of ``bts_tpu/data/tools/make_manifests.py`` (it imports no jax); run it
as ``python -m bts_tpu_torch.data.tools.make_manifests``.

The reference ships pre-built manifests in train_test_inputs/ (L1 in
SURVEY.md): `image_rel_path gt_rel_path focal` lines. This tool regenerates
them from an extracted dataset tree instead of vendoring 47k-line data files:

  * NYU: walks official_splits/{train,test} (or the sync/ train tree),
    pairing rgb_*.jpg with sync_depth_*.png at the fixed Kinect focal
    518.8579 (the constant the reference uses throughout, e.g.
    tensorflow/bts_sequence.py:64).
  * KITTI: walks a raw-sync tree plus data_depth_annotated, reading each
    date's calib_cam_to_cam.txt P_rect_02/P_rect_03 for the true per-drive
    focal, emitting right-camera columns for --use_right training
    (pytorch/bts_dataloader.py:99-104 line format).

Also includes the NYU raw RGB/depth sync pairing (capability parity with
utils/sync_project_frames_multi_threads.m, reference D6) in pure Python.
"""

from __future__ import annotations

import glob
import os
import re
import sys
from typing import List, Optional

NYU_FOCAL = 518.8579


def nyu_manifest(root: str, split_dir: str) -> List[str]:
    """Lines for every rgb/sync_depth pair under root/split_dir."""
    lines = []
    base = os.path.join(root, split_dir)
    for rgb in sorted(glob.glob(os.path.join(base, "*", "rgb_*.jpg"))):
        scene = os.path.basename(os.path.dirname(rgb))
        idx = re.search(r"rgb_(\d+)\.jpg$", rgb).group(1)
        depth = os.path.join(
            os.path.dirname(rgb), f"sync_depth_{idx}.png"
        )
        if os.path.exists(depth):
            rel_rgb = os.path.relpath(rgb, base)
            rel_depth = os.path.relpath(depth, base)
            lines.append(f"{rel_rgb} {rel_depth} {NYU_FOCAL}")
    return lines


def _kitti_focal(calib_file: str, cam: int = 2) -> Optional[float]:
    if not os.path.exists(calib_file):
        return None
    with open(calib_file) as f:
        for line in f:
            if line.startswith(f"P_rect_0{cam}:"):
                return float(line.split()[1])
    return None


def kitti_manifest(
    raw_root: str, gt_root: str, use_right: bool = True
) -> List[str]:
    """Lines for every annotated KITTI frame with image_02 (+image_03)."""
    lines = []
    pattern = os.path.join(
        gt_root, "*", "*", "proj_depth", "groundtruth", "image_02", "*.png"
    )
    for gt in sorted(glob.glob(pattern)):
        parts = gt.split(os.sep)
        fname = parts[-1]
        drive = parts[-5]
        split = parts[-6]
        m = re.match(r"(\d{4}_\d{2}_\d{2})", drive)
        if not m:
            continue
        date = m.group(1)
        img = os.path.join(date, drive, "image_02", "data", fname)
        if not os.path.exists(os.path.join(raw_root, img)):
            continue
        focal = _kitti_focal(
            os.path.join(raw_root, date, "calib_cam_to_cam.txt")
        ) or 721.5377
        gt_rel = os.path.join(
            split, drive, "proj_depth", "groundtruth", "image_02", fname
        )
        line = f"{img} {gt_rel} {focal}"
        if use_right:
            img_r = os.path.join(date, drive, "image_03", "data", fname)
            gt_r = gt_rel.replace("image_02", "image_03")
            if os.path.exists(os.path.join(raw_root, img_r)):
                line += f" {img_r} {gt_r}"
        lines.append(line)
    return lines


def sync_nyu_raw(scene_dir: str, out_dir: str, sample_step: int = 7) -> int:
    """Pair nearest raw RGB (.ppm) and depth (.pgm) frames by timestamp —
    the python equivalent of the reference's MATLAB sync tool (D6).

    Raw NYU filenames encode timestamps: r-<epoch>.<us>-<seq>.ppm /
    d-<epoch>.<us>-<seq>.pgm. For every sample_step'th depth frame, the
    closest RGB frame is selected.
    """

    def stamps(paths):
        out = []
        for p in paths:
            m = re.search(r"[rd]-(\d+\.\d+)-", os.path.basename(p))
            if m:
                out.append((float(m.group(1)), p))
        return sorted(out)

    rgbs = stamps(glob.glob(os.path.join(scene_dir, "r-*.ppm")))
    depths = stamps(glob.glob(os.path.join(scene_dir, "d-*.pgm")))
    if not rgbs or not depths:
        return 0
    os.makedirs(out_dir, exist_ok=True)

    from PIL import Image
    import numpy as np

    n = 0
    ri = 0
    for di in range(0, len(depths), sample_step):
        dt, dpath = depths[di]
        while ri + 1 < len(rgbs) and abs(rgbs[ri + 1][0] - dt) <= abs(
            rgbs[ri][0] - dt
        ):
            ri += 1
        _, rpath = rgbs[ri]
        rgb = Image.open(rpath)
        depth_raw = np.asarray(Image.open(dpath), dtype=np.float32)
        # Kinect disparity -> depth in meters (standard NYU toolbox params),
        # stored as uint16 millimeters like the sync/ tree.
        with np.errstate(divide="ignore"):
            depth_m = 351.3 / (1092.5 - depth_raw)
        depth_m[(depth_raw >= 1092.5) | (depth_m < 0) | (depth_m > 10.0)] = 0
        rgb.save(os.path.join(out_dir, f"rgb_{n:05d}.jpg"))
        Image.fromarray((depth_m * 1000).astype(np.uint16)).save(
            os.path.join(out_dir, f"sync_depth_{n:05d}.png")
        )
        n += 1
    return n


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) >= 3 and argv[0] == "nyu":
        lines = nyu_manifest(argv[1], argv[2])
    elif len(argv) >= 3 and argv[0] == "kitti":
        lines = kitti_manifest(argv[1], argv[2])
    elif len(argv) == 3 and argv[0] == "sync":
        n = sync_nyu_raw(argv[1], argv[2])
        print(f"Synced {n} frames")
        return 0
    else:
        print(
            "usage: make_manifests.py nyu <root> <split_dir> | "
            "kitti <raw_root> <gt_root> | sync <scene_dir> <out_dir>"
        )
        return 1
    for l in lines:
        print(l)
    return 0


if __name__ == "__main__":
    sys.exit(main())
