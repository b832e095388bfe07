"""Wrapper of the hand-written CUDA LPG forward (``csrc/lpg.cu``).

The CUDA port of ``bts_tpu/ops/lpg_pallas.py``, with the decoder's
``/ max_depth`` and cast to its compute dtype in the kernel's epilogue.
``lpg_cuda`` checks its input, allocates the output and launches on the
current stream without synchronising. It never falls back to the plain
version (``bts_tpu_torch.ops.lpg.lpg_scaled_reference``): it launches or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from bts_tpu_torch.ops import _build

# Kernel launches in this process; bumped once per launch, nowhere else.
LAUNCHES = 0

RATIOS = (2, 4, 8)
OUT_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def inv_scale(max_depth: Optional[float]) -> float:
    """The f32 factor the kernel multiplies by: f32(1 / f32(max_depth)), as
    PyTorch's CUDA division of a tensor by a Python float does; 1 for None."""
    if max_depth is None:
        return 1.0
    return (torch.tensor(1.0) / torch.tensor(float(max_depth))).item()


def lpg_cuda(plane_eq: torch.Tensor, upratio: int, max_depth: Optional[float] = None,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA LPG. plane_eq (B,H,W,4) f32 contiguous on a card -> (B, H*r, W*r)
    in ``out_dtype`` (f32 or bf16), divided by ``max_depth`` unless None."""
    global LAUNCHES
    if not plane_eq.is_cuda:
        raise ValueError(f"lpg_cuda needs a CUDA tensor (got {plane_eq.device})")
    if plane_eq.dtype != torch.float32:
        raise TypeError(f"lpg_cuda needs float32 planes (got {plane_eq.dtype})")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"lpg_cuda writes float32 or bfloat16 (got {out_dtype})")
    if plane_eq.dim() != 4 or plane_eq.shape[-1] != 4:
        raise ValueError(f"lpg_cuda needs shape (B,H,W,4) (got {tuple(plane_eq.shape)})")
    if not plane_eq.is_contiguous():
        raise ValueError("lpg_cuda needs a contiguous plane_eq")
    if plane_eq.data_ptr() % 16:
        raise ValueError("lpg_cuda needs a 16-byte aligned plane_eq (float4 loads)")
    r = int(upratio)
    b, h, w, _ = plane_eq.shape
    if r not in RATIOS or max(b * h, h * r, w * r) > _INT_MAX:
        raise ValueError(f"lpg_cuda takes r in {RATIOS} (got r={r}, shape="
                         f"{tuple(plane_eq.shape)})")
    out = torch.empty((b, h * r, w * r), dtype=out_dtype, device=plane_eq.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(plane_eq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpg_forward(plane_eq.data_ptr(), out.data_ptr(), b, h, w, r,
                             inv_scale(max_depth), int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lpg_forward launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out
