"""Wrapper of the hand-written CUDA LPG forward (``csrc/lpg.cu``).

The CUDA port of ``bts_tpu/ops/lpg_pallas.py``. ``lpg_cuda`` checks its
input, allocates the output and launches on the current stream without
synchronising. It never falls back to the plain version
(``bts_tpu_torch.ops.lpg.lpg_reference``): it launches or raises.
"""

from __future__ import annotations

import torch

from bts_tpu_torch.ops import _build

# Kernel launches in this process; bumped once per launch, nowhere else.
LAUNCHES = 0

_INT_MAX = 2**31 - 1


def lpg_cuda(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """CUDA LPG. plane_eq (B,H,W,4) f32 contiguous on a card -> (B, H*r, W*r)."""
    global LAUNCHES
    if not plane_eq.is_cuda:
        raise ValueError(f"lpg_cuda needs a CUDA tensor (got {plane_eq.device})")
    if plane_eq.dtype != torch.float32:
        raise TypeError(f"lpg_cuda needs float32 (got {plane_eq.dtype})")
    if plane_eq.dim() != 4 or plane_eq.shape[-1] != 4:
        raise ValueError(f"lpg_cuda needs shape (B,H,W,4) (got {tuple(plane_eq.shape)})")
    if not plane_eq.is_contiguous():
        raise ValueError("lpg_cuda needs a contiguous plane_eq")
    if plane_eq.data_ptr() % 16:
        raise ValueError("lpg_cuda needs a 16-byte aligned plane_eq (float4 loads)")
    r = int(upratio)
    b, h, w, _ = plane_eq.shape
    if r < 1 or max(b, h * r, w * r) > _INT_MAX:
        raise ValueError(f"lpg_cuda: bad ratio or size (r={r}, shape={tuple(plane_eq.shape)})")
    out = torch.empty((b, h * r, w * r), dtype=torch.float32, device=plane_eq.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(plane_eq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpg_forward_f32(plane_eq.data_ptr(), out.data_ptr(), b, h, w, r, stream)
    if rc != 0:
        raise RuntimeError(f"lpg_forward_f32 launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
