"""The native CPU LPG (``csrc/lpg_cpu.cc``): ``bts_tpu/ops/lpg_ffi.py``.

``lpg_impl ffi``: the LPG forward and its gradient (the n4 factor included)
as compiled C++ on CPU tensors, built with g++ at first use
(``ops/_build.py``) and called through ctypes. Each wrapper checks its
inputs, allocates the output and calls the native function; it takes f32
CPU tensors only and raises for any other, a CUDA tensor included (no copy
to the host). ``LpgCpu`` is the autograd function whose forward and backward
are the two calls; ``ops/lpg.py`` applies ``/ max_depth`` and the cast after
it, as ``bts_tpu`` divides after ``lpg_ffi``.
"""

from __future__ import annotations

import torch

from bts_tpu_torch.ops import _build

# Native calls in this process; each bumped once per call, nowhere else.
CALLS = 0
BWD_CALLS = 0


def _check(fn: str, t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{fn} is the native CPU kernel: it needs a CPU tensor for {what} "
                         f"(got {t.device})")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn} needs float32 {what} (got {t.dtype})")


def _check_planes(fn: str, plane_eq: torch.Tensor, upratio: int) -> int:
    _check(fn, plane_eq, "plane_eq")
    if plane_eq.dim() != 4 or plane_eq.shape[-1] != 4:
        raise ValueError(f"{fn} needs shape (B,H,W,4) (got {tuple(plane_eq.shape)})")
    r = int(upratio)
    if r < 1:
        raise ValueError(f"{fn} needs r >= 1 (got {r})")
    return r


def lpg_cpu(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """Native LPG forward: plane_eq (B,H,W,4) f32 on the CPU -> (B, H*r, W*r) f32."""
    global CALLS
    r = _check_planes("lpg_cpu", plane_eq, upratio)
    plane_eq = plane_eq.contiguous()
    b, h, w, _ = plane_eq.shape
    out = torch.empty((b, h * r, w * r), dtype=torch.float32)
    if out.numel():
        _build.load_cpu_library().lpg_cpu_forward(plane_eq.data_ptr(), out.data_ptr(), b, h, w,
                                                  r)
    CALLS += 1
    return out


def lpg_backward_cpu(plane_eq: torch.Tensor, grad: torch.Tensor, upratio: int) -> torch.Tensor:
    """Native LPG gradient with respect to plane_eq: (B,H,W,4) f32, from
    ``grad`` = dL/d out, (B, H*r, W*r) f32 on the CPU."""
    global BWD_CALLS
    r = _check_planes("lpg_backward_cpu", plane_eq, upratio)
    _check("lpg_backward_cpu", grad, "grad")
    b, h, w, _ = plane_eq.shape
    if tuple(grad.shape) != (b, h * r, w * r):
        raise ValueError(f"lpg_backward_cpu: grad shape {tuple(grad.shape)}, expected "
                         f"{(b, h * r, w * r)}")
    plane_eq, grad = plane_eq.contiguous(), grad.contiguous()
    out = torch.empty_like(plane_eq)
    if out.numel():
        _build.load_cpu_library().lpg_cpu_backward(grad.data_ptr(), plane_eq.data_ptr(),
                                                   out.data_ptr(), b, h, w, r)
    BWD_CALLS += 1
    return out


class LpgCpu(torch.autograd.Function):
    """The native forward, and the native gradient as its backward."""

    @staticmethod
    def forward(ctx, plane_eq, upratio):
        ctx.upratio = upratio
        ctx.save_for_backward(plane_eq)
        return lpg_cpu(plane_eq, upratio)

    @staticmethod
    def backward(ctx, grad):
        (plane_eq,) = ctx.saved_tensors
        return lpg_backward_cpu(plane_eq, grad, ctx.upratio), None
