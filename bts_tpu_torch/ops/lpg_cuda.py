"""Wrappers of the hand-written CUDA LPG kernels (``csrc/lpg.cu``).

``lpg_cuda`` is the CUDA port of ``bts_tpu/ops/lpg_pallas.py``, with the
decoder's ``/ max_depth`` and cast to its compute dtype in the kernel's
epilogue. ``lpg_backward_cuda`` is the gradient of that site with respect to
the planes (``bts_tpu/ops/lpg.py::_lpg_bwd``), with the cast of the incoming
gradient and the scale fused. Each checks its inputs, allocates the output
and launches on the current stream without synchronising. Neither falls back
to its plain version (``bts_tpu_torch.ops.lpg.lpg_scaled_reference``,
``lpg_backward_scaled``): each launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from bts_tpu_torch.ops import _build, count_launches

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
LAUNCHES = 0
BWD_LAUNCHES = 0
count_launches(__name__, "LAUNCHES", "BWD_LAUNCHES")

RATIOS = (2, 4, 8)
OUT_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def inv_scale(max_depth: Optional[float]) -> float:
    """The f32 factor the kernel multiplies by: f32(1 / f32(max_depth)), as
    PyTorch's CUDA division of a tensor by a Python float does; 1 for None."""
    if max_depth is None:
        return 1.0
    return (torch.tensor(1.0) / torch.tensor(float(max_depth))).item()


def _check_planes(fn: str, plane_eq: torch.Tensor, upratio: int) -> int:
    """Raise unless plane_eq is what the kernels take; returns r."""
    if not plane_eq.is_cuda:
        raise ValueError(f"{fn} needs a CUDA tensor (got {plane_eq.device})")
    if plane_eq.dtype != torch.float32:
        raise TypeError(f"{fn} needs float32 planes (got {plane_eq.dtype})")
    if plane_eq.dim() != 4 or plane_eq.shape[-1] != 4:
        raise ValueError(f"{fn} needs shape (B,H,W,4) (got {tuple(plane_eq.shape)})")
    if not plane_eq.is_contiguous():
        raise ValueError(f"{fn} needs a contiguous plane_eq")
    if plane_eq.data_ptr() % 16:
        raise ValueError(f"{fn} needs a 16-byte aligned plane_eq (float4 loads)")
    r = int(upratio)
    b, h, w, _ = plane_eq.shape
    if r not in RATIOS or max(b * h, h * r, w * r) > _INT_MAX:
        raise ValueError(f"{fn} takes r in {RATIOS} (got r={r}, shape="
                         f"{tuple(plane_eq.shape)})")
    return r


def lpg_cuda(plane_eq: torch.Tensor, upratio: int, max_depth: Optional[float] = None,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA LPG. plane_eq (B,H,W,4) f32 contiguous on a card -> (B, H*r, W*r)
    in ``out_dtype`` (f32 or bf16), divided by ``max_depth`` unless None."""
    global LAUNCHES
    r = _check_planes("lpg_cuda", plane_eq, upratio)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"lpg_cuda writes float32 or bfloat16 (got {out_dtype})")
    b, h, w, _ = plane_eq.shape
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


def lpg_backward_cuda(plane_eq: torch.Tensor, grad: torch.Tensor, upratio: int,
                      max_depth: Optional[float] = None) -> torch.Tensor:
    """CUDA gradient of ``lpg_cuda``'s site with respect to plane_eq:
    (B,H,W,4) f32, from ``grad`` = dL/d out, (B, H*r, W*r) in f32 or bf16
    with any strides, cast to f32 and divided by ``max_depth`` (unless None)
    in the kernel."""
    global BWD_LAUNCHES
    r = _check_planes("lpg_backward_cuda", plane_eq, upratio)
    b, h, w, _ = plane_eq.shape
    if grad.device != plane_eq.device:
        raise ValueError(f"lpg_backward_cuda: grad on {grad.device}, planes on "
                         f"{plane_eq.device}")
    if grad.dtype not in OUT_DTYPES:
        raise TypeError(f"lpg_backward_cuda reads float32 or bfloat16 (got {grad.dtype})")
    if tuple(grad.shape) != (b, h * r, w * r):
        raise ValueError(f"lpg_backward_cuda: grad shape {tuple(grad.shape)}, expected "
                         f"{(b, h * r, w * r)}")
    out = torch.empty_like(plane_eq)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(plane_eq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpg_backward(plane_eq.data_ptr(), grad.data_ptr(), out.data_ptr(), b, h, w, r,
                              *grad.stride(), inv_scale(max_depth), int(max_depth is not None),
                              int(grad.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lpg_backward launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    return out
