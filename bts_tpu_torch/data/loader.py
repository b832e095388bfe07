"""Data loaders: a copy of ``bts_tpu/data/loader.py``.

  * ``TrainLoader``: each process's shard of a deterministic per-epoch
    shuffle (DistributedSampler.set_epoch, pytorch/bts_main.py:435-437),
    loaded on host threads, as NHWC numpy batches.
  * ``EvalLoader``: exact-count, no-padding sharding -- rank r takes
    indices[r::world], as the reference's DistributedSamplerNoEvenlyDivisible
    does (distributed_sampler_no_evenly_divisible.py:7-72). Batches are
    padded with an explicit validity weight instead of dropping samples, so
    the model runs at batch > 1 and metric sums stay exact.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Optional

import numpy as np

from bts_tpu_torch.config import Config
from bts_tpu_torch.data import transforms
from bts_tpu_torch.data.manifest import ManifestEntry, load_manifest


class TrainLoader:
    """Deterministic, sharded, threaded training loader."""

    def __init__(
        self,
        cfg: Config,
        num_shards: int = 1,
        shard_index: int = 0,
        num_workers: Optional[int] = None,
    ):
        self.cfg = cfg
        self.entries = load_manifest(cfg.filenames_file)
        self.num_shards = num_shards
        self.shard_index = shard_index
        # cfg.batch_size is the GLOBAL batch (the reference's DDP divides it
        # per worker, pytorch/bts_main.py:351): each process loads its slice.
        self.host_batch = max(cfg.batch_size // max(num_shards, 1), 1)
        self.num_workers = num_workers or max(cfg.num_threads, 1)
        self.normalization = cfg.resolved_normalization  # resolved once

    def __len__(self):
        return len(self.entries)

    def steps_per_epoch(self) -> int:
        """Floor division: the final partial batch of each epoch is dropped
        (a fixed batch shape, and no padding to bias BN's batch statistics),
        as in ``bts_tpu``; the reference keeps it (drop_last=False). Every
        shard takes the smallest shard's count, so data-parallel ranks run
        the same steps (``bts_tpu`` counts its own shard's: where the shards
        differ in length, its ranks would part)."""
        return len(self.entries) // max(self.num_shards, 1) // self.host_batch

    def _shard_indices(self, epoch: int) -> np.ndarray:
        """Per-epoch deterministic shuffle, then this process's shard."""
        order = np.random.default_rng(self.cfg.seed + epoch).permutation(len(self.entries))
        return order[self.shard_index :: self.num_shards]

    def _load_one(self, entry: ManifestEntry, rng: np.random.Generator):
        cfg = self.cfg
        image_path, depth_path = entry.image_path, entry.gt_path
        # KITTI --use_right: 50% chance to swap to the right-camera pair
        # (pytorch/bts_dataloader.py:99-101).
        if (cfg.dataset == "kitti" and cfg.use_right and entry.right_image_path is not None
                and rng.random() > 0.5):
            image_path, depth_path = entry.right_image_path, entry.right_gt_path
        paths = (os.path.join(cfg.data_path, image_path), os.path.join(cfg.gt_path, depth_path))
        if cfg.device_augment:
            # Host: decode, static crops, rotation. Crop, flip, photometric
            # and normalization run on the card (data/device_augment.py).
            image, depth = transforms.load_raw_train_sample(
                *paths, cfg.dataset, rng, do_kb_crop=cfg.do_kb_crop,
                do_random_rotate=cfg.do_random_rotate, degree=cfg.degree)
        else:
            image, depth = transforms.load_train_sample(
                *paths, cfg.dataset, cfg.input_height, cfg.input_width, rng,
                do_kb_crop=cfg.do_kb_crop, do_random_rotate=cfg.do_random_rotate,
                degree=cfg.degree, normalization=self.normalization)
        return image, depth, np.float32(entry.focal)

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield batches {'image' (B,H,W,3), 'depth' (B,H,W,1), 'focal' (B,)};
        sample i of the epoch draws from default_rng((seed, epoch, index))."""
        idx = self._shard_indices(epoch)
        n = self.steps_per_epoch() * self.host_batch
        with cf.ThreadPoolExecutor(self.num_workers) as pool:

            def submit(i):
                rng = np.random.default_rng((self.cfg.seed, epoch, int(idx[i])))
                return pool.submit(self._load_one, self.entries[idx[i]], rng)

            window = self.host_batch * 2  # samples in flight beyond the current batch
            futures = [submit(i) for i in range(min(window, n))]
            for start in range(0, n, self.host_batch):
                results = [f.result() for f in futures[start:start + self.host_batch]]
                while len(futures) < min(start + self.host_batch + window, n):
                    futures.append(submit(len(futures)))
                images, depths, focals = zip(*results)
                yield {"image": np.stack(images), "depth": np.stack(depths),
                       "focal": np.stack(focals)}


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
