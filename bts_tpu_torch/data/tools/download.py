"""Dataset download helpers.

The port's copy of ``bts_tpu/data/tools/download.py`` (it imports no jax); run it
as ``python -m bts_tpu_torch.data.tools.download``.

Capability parity with utils/download_from_gdrive.py and the aria2c archive
lists (reference D7), re-designed:

  * `gdrive_download` implements the confirm-token dance for large Google
    Drive files (the reference's mechanism, our implementation).
  * `kitti_archives_for_manifest` derives the exact set of KITTI raw
    archives a manifest needs (instead of a hardcoded 66-archive list, we
    compute it from the split file — only what's required is fetched).
  * `write_aria2_list` emits an aria2c-compatible URL list.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Iterable, List, Set

KITTI_RAW_URL = "https://s3.eu-central-1.amazonaws.com/avg-kitti/raw_data"
NYU_RAW_URL = (
    "http://horatio.cs.nyu.edu/mit/silberman/nyu_depth_v2"
)

# Official NYUv2 raw distribution parts (scene-category zips). This is the
# dataset's own part list — not derivable from manifests — kept byte-equal
# to the reference's utils/nyudepthv2_archives_to_download.txt (verified by
# tests/test_data_tools.py).
NYU_ARCHIVES = (
    "basements.zip", "bathrooms_part1.zip", "bathrooms_part2.zip",
    "bathrooms_part3.zip", "bathrooms_part4.zip", "bedrooms_part1.zip",
    "bedrooms_part2.zip", "bedrooms_part3.zip", "bedrooms_part4.zip",
    "bedrooms_part5.zip", "bedrooms_part6.zip", "bedrooms_part7.zip",
    "bookstore_part1.zip", "bookstore_part2.zip", "bookstore_part3.zip",
    "cafe.zip", "classrooms.zip", "dining_rooms_part1.zip",
    "dining_rooms_part2.zip", "furniture_stores.zip", "home_offices.zip",
    "kitchens_part1.zip", "kitchens_part2.zip", "kitchens_part3.zip",
    "libraries.zip", "living_rooms_part1.zip", "living_rooms_part2.zip",
    "living_rooms_part3.zip", "living_rooms_part4.zip", "misc_part1.zip",
    "misc_part2.zip", "offices_part1.zip", "offices_part2.zip",
    "office_kitchens.zip", "playrooms.zip", "reception_rooms.zip",
    "studies.zip", "study_rooms.zip",
)

_DRIVE_RE = re.compile(r"(\d{4}_\d{2}_\d{2})_drive_(\d{4})")


def nyu_archive_urls() -> List[str]:
    """Full NYUv2 raw archive URL list (reference D7 aria2c list)."""
    return [f"{NYU_RAW_URL}/{name}" for name in NYU_ARCHIVES]


def kitti_archives_for_manifest(manifest_path: str) -> List[str]:
    """Unique '<date>_drive_<id>' archive URLs needed by a split manifest."""
    drives: Set[str] = set()
    with open(manifest_path) as f:
        for line in f:
            m = _DRIVE_RE.search(line)
            if m:
                drives.add(f"{m.group(1)}_drive_{m.group(2)}")
    urls = []
    for d in sorted(drives):
        urls.append(f"{KITTI_RAW_URL}/{d}/{d}_sync.zip")
    # Calibration files per date.
    for date in sorted({d[:10] for d in drives}):
        urls.append(f"{KITTI_RAW_URL}/{date}_calib.zip")
    return urls


def write_aria2_list(urls: Iterable[str], out_path: str) -> None:
    with open(out_path, "w") as f:
        for u in urls:
            f.write(u + "\n")


def gdrive_download(file_id: str, dest: str, chunk_size: int = 1 << 20) -> str:
    """Download a (large) Google Drive file, handling the confirm token."""
    import requests

    url = "https://docs.google.com/uc?export=download"
    with requests.Session() as session:
        resp = session.get(url, params={"id": file_id}, stream=True)
        token = None
        for key, value in resp.cookies.items():
            if key.startswith("download_warning"):
                token = value
        if token:
            resp = session.get(
                url, params={"id": file_id, "confirm": token}, stream=True
            )
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        with open(dest, "wb") as f:
            for chunk in resp.iter_content(chunk_size):
                if chunk:
                    f.write(chunk)
    return dest


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) == 2 and argv[0] == "--kitti-list":
        urls = kitti_archives_for_manifest(argv[1])
        for u in urls:
            print(u)
        return 0
    if argv == ["--nyu-list"]:
        for u in nyu_archive_urls():
            print(u)
        return 0
    if len(argv) == 2:
        gdrive_download(argv[0], argv[1])
        return 0
    print(
        "usage: download.py <gdrive_file_id> <dest> | "
        "download.py --kitti-list <manifest.txt> | download.py --nyu-list"
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
