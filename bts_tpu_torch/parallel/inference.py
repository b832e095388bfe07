"""Data-parallel batched inference: ``bts_tpu/parallel/inference.py`` in
PyTorch.

One replica of the model a device, copied once and reused by every call;
the batch split into equal parts, part i on device i; the depth left on
each device, not gathered. No collective: each replica's forward is the
serving forward (eval mode, ``apps/predict.py``'s compute context), so on a
card the fused dense-layer and LPG kernels serve it. The devices' work is
queued from one host thread without waiting, so the cards run at once.

Usage:
    fwd = make_sharded_forward(model, ["cuda:0", "cuda:1"], cfg)
    depths = fwd(image, focal)   # [(B/2, H, W) on cuda:0, (B/2, H, W) on cuda:1]
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from bts_tpu_torch.apps.predict import compute_context
from bts_tpu_torch.config import Config


def make_sharded_forward(model: nn.Module, devices: Sequence, cfg: Optional[Config] = None
                         ) -> Callable[[torch.Tensor, torch.Tensor], List[torch.Tensor]]:
    """fn(image (B,3,H,W), focal (B,)) -> the final depth (B/n, H, W) f32 of
    each of the n ``devices``' parts, in device order. B must be divisible
    by n (a ValueError otherwise, where the jitted JAX forward fails). The
    replicas are copies of ``model`` as it is now, in eval mode; ``cfg``'s
    ``compute_dtype`` picks f32 (the default) or bf16 autocast."""
    devices = [torch.device(d) for d in devices]
    cfg = cfg or Config()
    replicas = [copy.deepcopy(model).to(d).eval() for d in devices]

    @torch.no_grad()
    def forward(image: torch.Tensor, focal: torch.Tensor) -> List[torch.Tensor]:
        n = len(devices)
        if image.shape[0] % n:
            raise ValueError(f"a batch of {image.shape[0]} does not split over {n} devices")
        k = image.shape[0] // n
        out = []
        for i, (device, replica) in enumerate(zip(devices, replicas)):
            x = image[i * k:(i + 1) * k].to(device, non_blocking=True)
            f = focal[i * k:(i + 1) * k].to(device, non_blocking=True)
            with compute_context(cfg, device):
                out.append(replica(x, f)[-1][:, 0].float())
        return out

    return forward
