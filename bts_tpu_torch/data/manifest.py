"""Split-manifest parsing (a copy of ``bts_tpu/data/manifest.py``).

Reference: train_test_inputs/*.txt — whitespace-separated lines
``image_rel_path gt_rel_path focal``; KITTI train lines append the
right-camera image+gt as fields 3-4 (pytorch/bts_dataloader.py:99-104).
Missing gt is recorded as ``None`` (eval files use the literal 'None').
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    image_path: str
    gt_path: Optional[str]
    focal: float
    right_image_path: Optional[str] = None
    right_gt_path: Optional[str] = None


def parse_manifest_line(line: str) -> ManifestEntry:
    parts = line.split()
    if len(parts) < 3:
        # Some reference test manifests are `image focal` (no gt).
        image, focal = parts[0], float(parts[-1])
        return ManifestEntry(image, None, focal)
    gt = None if parts[1] == "None" else parts[1]
    right_img = parts[3] if len(parts) > 4 else None
    right_gt = parts[4] if len(parts) > 4 else None
    return ManifestEntry(parts[0], gt, float(parts[2]), right_img, right_gt)


def load_manifest(path: str) -> List[ManifestEntry]:
    with open(path) as f:
        return [parse_manifest_line(line) for line in f if line.strip()]
