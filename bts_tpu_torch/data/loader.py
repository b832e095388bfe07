"""The eval/test data loader: ``EvalLoader`` of ``bts_tpu/data/loader.py``.

Exact-count, no-padding sharding: rank r takes indices[r::world], as the
reference's DistributedSamplerNoEvenlyDivisible does
(distributed_sampler_no_evenly_divisible.py:7-72). Batches are padded with
an explicit validity weight instead of dropping samples, so the model runs
at batch > 1 and metric sums stay exact. The training loader comes with
the training slice.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from bts_tpu_torch.config import Config
from bts_tpu_torch.data import transforms
from bts_tpu_torch.data.manifest import load_manifest


class EvalLoader:
    """Exact-count eval loader with uneven sharding (no padding of the
    per-rank index set; batch padding carries a weight=0 flag)."""

    def __init__(
        self,
        cfg: Config,
        mode: str = "online_eval",
        num_shards: int = 1,
        shard_index: int = 0,
        batch_size: Optional[int] = None,
    ):
        self.cfg = cfg
        self.mode = mode
        manifest = (
            cfg.filenames_file_eval
            if mode == "online_eval" and cfg.filenames_file_eval
            else cfg.filenames_file
        )
        self.entries = load_manifest(manifest)
        self.indices: List[int] = list(range(shard_index, len(self.entries), num_shards))
        self.batch_size = batch_size or max(cfg.eval_batch_size, 1)
        self.normalization = cfg.resolved_normalization  # resolved once

    def __len__(self):
        return len(self.indices)

    def _data_root(self):
        cfg = self.cfg
        if self.mode == "online_eval":
            return cfg.data_path_eval or cfg.data_path, cfg.gt_path_eval or cfg.gt_path
        return cfg.data_path, cfg.gt_path

    def samples(self) -> Iterator[dict]:
        """Yield single samples {'image', 'depth' (or None), 'focal',
        'entry'}: image normalized HW3, depth in meters HW1."""
        data_root, gt_root = self._data_root()
        cfg = self.cfg
        for i in self.indices:
            entry = self.entries[i]
            gt_path = (
                os.path.join(gt_root, entry.gt_path)
                if (entry.gt_path and self.mode == "online_eval")
                else None
            )
            image, depth = transforms.load_eval_sample(
                os.path.join(data_root, entry.image_path),
                gt_path,
                cfg.dataset,
                do_kb_crop=cfg.do_kb_crop,
                normalization=self.normalization,
            )
            yield {"image": image, "depth": depth, "focal": np.float32(entry.focal),
                   "entry": entry}

    def batches(self) -> Iterator[dict]:
        """Yield fixed-shape batches with a validity 'weight' vector; the
        final partial batch is padded (weight 0).

        Samples are grouped by image shape, so a mixed-size manifest yields
        every sample exactly once, in a batch of its own shape group.
        """
        bs = self.batch_size
        bufs: dict = {}  # image shape -> buffered samples
        for s in self.samples():
            buf = bufs.setdefault(s["image"].shape, [])
            buf.append(s)
            if len(buf) == bs:
                yield self._collate(buf, bs)
                buf.clear()
        for buf in bufs.values():
            if buf:
                yield self._collate(buf, bs)

    @staticmethod
    def _collate(buf: List[dict], bs: int) -> dict:
        n = len(buf)
        image = np.stack([s["image"] for s in buf])
        if n < bs:
            image = np.concatenate([image, np.repeat(image[-1:], bs - n, axis=0)])
        focal = np.array([s["focal"] for s in buf] + [buf[-1]["focal"]] * (bs - n),
                         dtype=np.float32)
        weight = np.array([1.0] * n + [0.0] * (bs - n), dtype=np.float32)
        depths = [s["depth"] for s in buf] + [buf[-1]["depth"]] * (bs - n)
        return {
            "image": image,
            "focal": focal,
            "weight": weight,
            "depths": depths,
            "entries": [s["entry"] for s in buf],
        }
