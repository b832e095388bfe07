"""Local Planar Guidance (LPG): plain PyTorch versions and the dispatch.

Port of ``bts_tpu/ops/lpg.py``. Given a per-cell plane equation
``(n1, n2, n3, n4)`` on an ``(H, W)`` grid and an integer ratio ``r``, the
output pixel ``(y, x)`` lies on the plane of cell ``(y//r, x//r)``:

    u = ((x % r) - (r - 1)/2) / r
    v = ((y % r) - (r - 1)/2) / r
    depth[y, x] = n4 / (n1*u + n2*v + n3)

Layout is ``bts_tpu``'s: ``plane_eq`` is ``(B, H, W, 4)`` and the output is
``(B, H*r, W*r)``. The gradient is the analytic one of ``bts_tpu``'s custom
VJP (the n4 factor included):

    d n1 = -sum_{tile} g * n4 * u / den^2
    d n2 = -sum_{tile} g * n4 * v / den^2
    d n3 = -sum_{tile} g * n4 / den^2
    d n4 =  sum_{tile} g / den

The decoder scales each full-resolution map by 1/max_depth and casts it to
its compute dtype; ``local_planar_guidance(..., max_depth, out_dtype)`` does
both in the same pass (``lpg_scaled_reference`` is the plain composition).
Its gradient takes the incoming gradient back through the cast and the scale
in the same pass (``lpg_backward_scaled`` is the plain composition).

Implementations (``impl``, ``bts_tpu``'s names so args files carry over):
  - ``auto`` / ``pallas``: the CUDA kernels (``ops/lpg_cuda.py``, forward
    and backward) on a CUDA tensor, the plain versions on a CPU tensor;
  - ``xla``: the plain version on any device (for timing and comparison);
  - ``ffi``: the native CPU kernel (``ops/lpg_cpu.py``, ``csrc/lpg_cpu.cc``)
    on f32 CPU tensors, forward and backward, then ``/ max_depth`` and the
    cast in PyTorch; it raises for a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

IMPLS = ("auto", "xla", "pallas", "ffi")


def _uv_grid(r: int, like: torch.Tensor) -> torch.Tensor:
    """Sub-pixel offsets (arange(r) - (r-1)/2) / r, shape (r,)."""
    return (torch.arange(r, dtype=like.dtype, device=like.device) - (r - 1) * 0.5) / r


def _planes(plane_eq: torch.Tensor):
    """n1..n4 broadcast over (B, H, r, W, r)."""
    return [plane_eq[..., i][:, :, None, :, None] for i in range(4)]


def _den(plane_eq: torch.Tensor, r: int):
    u = _uv_grid(r, plane_eq)
    n1, n2, n3, n4 = _planes(plane_eq)
    # (n1*u + n2*v) + n3: bts_tpu's order, which the CUDA kernel keeps.
    den = n1 * u + n2 * u[:, None, None] + n3
    return den, n4, u


def lpg_reference(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """Plain forward. plane_eq (B,H,W,4) -> (B, H*r, W*r)."""
    r = upratio
    b, h, w, _ = plane_eq.shape
    den, n4, _ = _den(plane_eq, r)
    return (n4 / den).reshape(b, h * r, w * r)


def lpg_scaled_reference(
    plane_eq: torch.Tensor, upratio: int, max_depth: float, dtype: torch.dtype
) -> torch.Tensor:
    """Plain decoder site: (lpg(plane_eq, r) / max_depth).to(dtype)."""
    return (lpg_reference(plane_eq, upratio) / max_depth).to(dtype)


def lpg_backward(plane_eq: torch.Tensor, grad: torch.Tensor, upratio: int) -> torch.Tensor:
    """Analytic gradient w.r.t. plane_eq (``bts_tpu.ops.lpg._lpg_bwd``)."""
    r = upratio
    b, h, w, _ = plane_eq.shape
    den, n4, u = _den(plane_eq, r)
    v = u[:, None, None]
    gt = grad.reshape(b, h, r, w, r)
    inv_den = 1.0 / den
    common = gt * n4 * inv_den * inv_den
    dn1 = -(common * u).sum(dim=(2, 4))
    dn2 = -(common * v).sum(dim=(2, 4))
    dn3 = -common.sum(dim=(2, 4))
    dn4 = (gt * inv_den).sum(dim=(2, 4))
    return torch.stack([dn1, dn2, dn3, dn4], dim=-1)


def lpg_backward_scaled(
    plane_eq: torch.Tensor, grad: torch.Tensor, upratio: int, max_depth: Optional[float]
) -> torch.Tensor:
    """Plain gradient of the decoder site ``lpg_scaled_reference`` w.r.t.
    plane_eq: the incoming gradient cast to plane_eq's dtype and divided by
    ``max_depth`` (unless None), as autograd takes the cast and the scale,
    then ``lpg_backward``."""
    grad = grad.to(plane_eq.dtype)
    if max_depth is not None:
        grad = grad / max_depth
    return lpg_backward(plane_eq, grad, upratio)


class _LocalPlanarGuidance(torch.autograd.Function):
    """Forward by the kernel or the plain version, scaled by 1/max_depth
    (unless None) and cast to out_dtype; the analytic backward (bts_tpu's
    VJP, which its Pallas kernel reuses) through the cast and the scale, by
    the backward kernel where the forward took the kernel."""

    @staticmethod
    def forward(ctx, plane_eq, upratio, use_kernel, max_depth, out_dtype):
        ctx.upratio, ctx.max_depth, ctx.use_kernel = upratio, max_depth, use_kernel
        ctx.save_for_backward(plane_eq)
        if use_kernel:
            from bts_tpu_torch.ops.lpg_cuda import lpg_cuda

            return lpg_cuda(plane_eq, upratio, max_depth, out_dtype)
        if max_depth is None:
            return lpg_reference(plane_eq, upratio).to(out_dtype)
        return lpg_scaled_reference(plane_eq, upratio, max_depth, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        (plane_eq,) = ctx.saved_tensors
        if ctx.use_kernel:
            from bts_tpu_torch.ops.lpg_cuda import lpg_backward_cuda

            dplane = lpg_backward_cuda(plane_eq, grad, ctx.upratio, ctx.max_depth)
        else:
            dplane = lpg_backward_scaled(plane_eq, grad, ctx.upratio, ctx.max_depth)
        return dplane, None, None, None, None


def check_impl(impl: str) -> None:
    """Raise unless ``impl`` is an LPG implementation the port runs."""
    if impl not in IMPLS:
        raise ValueError(f"lpg_impl must be one of {'/'.join(IMPLS)} (got {impl!r})")


def local_planar_guidance(
    plane_eq: torch.Tensor,
    upratio: int,
    impl: str = "auto",
    max_depth: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """LPG dispatch. plane_eq (B,H,W,4) -> depth (B, H*r, W*r), divided by
    ``max_depth`` unless it is None, in ``out_dtype`` (plane_eq's dtype when
    None): one pass for ``lpg_scaled_reference``'s composition.

    ``auto``/``pallas`` take the CUDA kernel for any tensor not on the CPU
    (the kernel's wrapper raises for a device it cannot launch on); there is
    no fallback to the plain version. ``ffi`` takes the native CPU kernel on
    plane_eq in f32 and raises for a tensor not on the CPU.
    """
    check_impl(impl)
    if impl == "ffi":
        if plane_eq.device.type != "cpu":
            raise ValueError("lpg_impl 'ffi' is the native CPU kernel: it takes CPU tensors "
                             f"(got {plane_eq.device}); use 'auto' on a card")
        from bts_tpu_torch.ops.lpg_cpu import LpgCpu

        depth = LpgCpu.apply(plane_eq.float(), upratio)
        if max_depth is not None:
            depth = depth / max_depth
        return depth.to(plane_eq.dtype if out_dtype is None else out_dtype)
    use_kernel = impl != "xla" and plane_eq.device.type != "cpu"
    out_dtype = plane_eq.dtype if out_dtype is None else out_dtype
    return _LocalPlanarGuidance.apply(plane_eq, upratio, use_kernel, max_depth, out_dtype)


def normalize_plane(plane: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the plane normal (first 3 channels of the last axis)."""
    normal = plane[..., :3]
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True).clamp_min(eps)
    return torch.cat([normal / norm, plane[..., 3:]], dim=-1)


def decode_plane_eq(
    raw: torch.Tensor, max_depth: float, theta_max: float = math.pi / 3
) -> torch.Tensor:
    """Raw (..., 3) head output -> unit plane equation (..., 4).

    theta = sigmoid(x0) * theta_max, phi = sigmoid(x1) * 2pi,
    dist = sigmoid(x2) * max_depth; n = (sin t cos p, sin t sin p, cos t, d).
    """
    theta = torch.sigmoid(raw[..., 0]) * theta_max
    phi = torch.sigmoid(raw[..., 1]) * (2 * math.pi)
    dist = torch.sigmoid(raw[..., 2]) * max_depth
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta), dist], dim=-1
    )
