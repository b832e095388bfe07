"""Start N ranks on this host: ``spawn(fn, cfg, nprocs)`` over
``torch.multiprocessing.spawn``.

Each child sets its device, joins the process group
(``mesh.init_data_parallel``), runs ``fn(cfg, dp)`` and leaves the group.
Rendezvous is a file in a fresh temporary directory (no port to collide on
when several jobs start at once), ``env://`` when the environment gives
MASTER_ADDR and MASTER_PORT, or the reference's ``--dist_url``. With
``--multiprocessing_distributed`` the reference's ``--world_size`` counts
nodes and ``--rank`` is this node's: the group holds ``world_size * N``
ranks (pytorch/bts_main.py:579-598). A child's exception makes ``spawn``
raise (the others are stopped); nothing is swallowed.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from bts_tpu_torch.config import Config
from bts_tpu_torch.parallel import mesh


def default_devices(nprocs: int) -> List[str]:
    """``cuda:0`` .. ``cuda:N-1``; a ValueError if the host has fewer cards
    (never fewer ranks than asked for)."""
    cards = torch.cuda.device_count()
    if nprocs > cards:
        raise ValueError(f"{nprocs} ranks asked for, but this host has {cards} CUDA devices")
    return [f"cuda:{i}" for i in range(nprocs)]


def rank_devices(device: str, num_devices: int) -> List[str]:
    """The device of each rank for ``--device`` and ``--num_devices``
    (``bts_tpu/config.py:106-107``: 0 means every local card):

      * a comma-separated list names each rank's device (``cuda:0,cuda:0``
        puts two ranks on one card; they need ``--dist_backend gloo``);
      * ``cpu``: ``num_devices`` ranks on the CPU (one for 0);
      * empty or ``cuda``: ``cuda:0`` .. ``cuda:N-1``, N = ``num_devices`` or
        every card (``default_devices``; ``cuda`` when the host has none,
        which the caller refuses);
      * one named card, ``cuda:k``: that card, for one rank.
    """
    if "," in device:
        devices = [d.strip() for d in device.split(",")]
        if num_devices not in (0, len(devices)):
            raise ValueError(f"--num_devices {num_devices} with {len(devices)} devices named")
        return devices
    if device == "cpu":
        return ["cpu"] * max(num_devices, 1)
    if device in ("", "cuda"):
        n = num_devices or torch.cuda.device_count()
        return default_devices(n) if n > 1 else ["cuda"]
    if num_devices > 1:
        raise ValueError(f"--device {device} names one device for {num_devices} ranks: name "
                         "each rank's (e.g. cuda:0,cuda:1)")
    return [device]


def _child(local_rank: int, fn: Callable, cfg: Config, devices: Sequence[str], backend: str,
           init_method: str, world: int, first_rank: int, result_dir: str) -> None:
    device = torch.device(devices[local_rank])
    if device.type == "cpu":
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    dp = mesh.init_data_parallel(device, backend, init_method, world, first_rank + local_rank)
    try:
        result = fn(cfg, dp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(result_dir, f"result_{local_rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, cfg: Config, nprocs: int, devices: Optional[Sequence[str]] = None,
          backend: Optional[str] = None) -> list:
    """Run ``fn(cfg, dp)`` on ``nprocs`` ranks of this host, rank i on
    ``devices[i]`` (default ``default_devices(nprocs)``), and return their
    results in rank order. ``fn`` must be a module-level function (the
    children import it). ``backend`` defaults to ``cfg.dist_backend``, else
    NCCL on cards and gloo on the CPU; NCCL needs one card a rank."""
    devices = list(devices) if devices is not None else default_devices(nprocs)
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks, {len(devices)} devices: {devices}")
    backend = backend or cfg.dist_backend or mesh.default_backend(devices[0])
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(f"NCCL needs one card a rank (devices {devices}); use the gloo backend")
    world, first_rank = nprocs, 0
    if cfg.multiprocessing_distributed and cfg.world_size > 1:
        world, first_rank = cfg.world_size * nprocs, cfg.rank * nprocs
    tmp = tempfile.mkdtemp(prefix="bts_tpu_torch_ranks_")
    try:
        if cfg.dist_url:
            init_method = cfg.dist_url
        elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init_method = "env://"
        else:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.spawn(
            _child, args=(fn, cfg, devices, backend, init_method, world, first_rank, tmp),
            nprocs=nprocs, join=True)
        results = []
        for i in range(nprocs):
            with open(os.path.join(tmp, f"result_{i}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
