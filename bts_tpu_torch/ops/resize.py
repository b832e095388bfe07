"""Bilinear resize of (B, C, H, W) maps that writes the dtype its reader
takes.

For x (B, C, H, W) and an output size (Ho, Wo), each output element is the
four-tap lerp of PyTorch's ``upsample_bilinear2d``: along each axis the
source coordinate of output index i is

    align_corners=True:  i * (n_in - 1) / (n_out - 1)   (0 where n_out is 1)
    align_corners=False: max((i + 0.5) * n_in / n_out - 0.5, 0)

with the scale rounded to float32 first; its floor is the first tap, the
next index (clamped at the edge) the second, and the fraction the second
tap's weight. The lerp is float32 whatever the input's dtype, and the
result is rounded to ``out_dtype`` (float32 or bfloat16) once, at the end.
That is what autocast computes around ``F.interpolate(mode="bilinear")``:
it casts a bf16 input to float32, resizes in float32, and the convolution
that reads the result rounds it to bf16 again.

- ``bilinear_plain``: ``F.interpolate`` of the input in float32 (autocast
  off), then the cast to ``out_dtype``, in plain PyTorch.
- ``bilinear_triton``: the kernel, written in Triton and compiled at its
  first launch in a process (``triton`` is imported there, never at
  import). It replaces no TPU kernel: the JAX package's resizes are XLA's,
  and this one is added because autocast makes each resize three passes
  (a cast in, the float32 resize, a cast out) and PyTorch's NCHW kernel
  loops over batch x channels inside each thread. Bound by bytes (about 10
  operations an output element). Every output element has its own lane:
  channels-last maps give a program a run of output pixels of one row and
  a block of channels, each tap a 16-byte vector of channels; other maps
  give a program a block of output rows and a block of columns. Each input
  element is read from memory about once (the taps of neighbouring outputs
  meet in L1 and L2), each output written once, in x's memory format.
- ``bilinear``: CPU tensors take the plain version; CUDA tensors launch the
  kernel or raise. The kernel has no backward: a CUDA call that autograd
  would record raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bts_tpu_torch.ops import count_launches

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
LAUNCHES = 0
count_launches(__name__, "LAUNCHES")

DTYPES = (torch.float32, torch.bfloat16)
# A program's output elements and warps (16 a thread: 1-2 16-byte vectors a
# tap in flight; the fastest of 8 settings timed at the DPT head's five
# calls on an H100); the channels a channels-last program takes at most,
# and the columns a program of a map with contiguous rows takes at most.
PROGRAM = (2048, 4)
MAX_BLOCK_C = 256
MAX_BLOCK_W = 128

_KERNEL = None


def bilinear_plain(x: torch.Tensor, size: Sequence[int], align_corners: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The resize in plain PyTorch: ``F.interpolate`` of x in float32
    (autocast off), cast to ``out_dtype``."""
    _check(x, size, out_dtype)
    with torch.autocast(x.device.type, enabled=False):
        y = F.interpolate(x.float(), tuple(size), mode="bilinear", align_corners=align_corners)
    return y.to(out_dtype)


def _kernel():
    """The Triton kernel, defined at the first launch of a process."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def taps(i, n_in, scale, ALIGN_CORNERS: tl.constexpr):
        """Output indices -> (first tap, second tap, second tap's weight).
        The source coordinate is rounded where PyTorch's CUDA kernels round
        it: left to the compiler, the weight's subtraction fuses with the
        product, which moved float32 outputs by up to 4e-4 at Depth
        Anything's sizes on an H100."""
        f = i.to(tl.float32)  # the scale below is broadcast to f's shape for libdevice
        if ALIGN_CORNERS:
            src = libdevice.mul_rn(f * 0 + scale, f)
        else:
            src = tl.maximum(libdevice.fma_rn(f * 0 + scale, f + 0.5, -0.5), 0.0)
        i0 = tl.minimum(src.to(tl.int32), n_in - 1)  # src >= 0: the cast floors
        lam = libdevice.sub_rn(src, i0.to(tl.float32))
        return i0, tl.minimum(i0 + 1, n_in - 1), lam

    # B, H, W and Ho are not specialised on (fewer variants to compile);
    # C and Wo are, which tells the compiler whether the masks cover whole
    # 16-byte vectors.
    @triton.jit(do_not_specialize=["B", "H", "W", "Ho"])
    def bilinear_resize_kernel(x_ptr, o_ptr, B, C, H, W, Ho, Wo, sxb, sxc, sxh, sxw,
                               sob, soc, soh, sow, scale_h, scale_w,
                               ALIGN_CORNERS: tl.constexpr, CHANNELS_LAST: tl.constexpr,
                               BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
        if CHANNELS_LAST:
            # Axis 0: (image, output row, run of BLOCK_M output pixels);
            # axis 1: a block of BLOCK_N channels, the contiguous dimension.
            pid = tl.program_id(0)
            runs = tl.cdiv(Wo, BLOCK_M)
            row = pid // runs
            b = (row // Ho).to(tl.int64)
            oy = row % Ho
            ox = (pid % runs) * BLOCK_M + tl.arange(0, BLOCK_M)
            c = (tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)).to(tl.int64)
            y0, y1, ly = taps(oy + tl.zeros([BLOCK_M], tl.int32), H, scale_h, ALIGN_CORNERS)
            x0, x1, lx = taps(ox, W, scale_w, ALIGN_CORNERS)
            mask = (ox < Wo)[:, None] & (c < C)[None, :]
            base = x_ptr + b * sxb + c[None, :] * sxc
            r0 = base + y0.to(tl.int64)[:, None] * sxh
            r1 = base + y1.to(tl.int64)[:, None] * sxh
            c0 = x0.to(tl.int64)[:, None] * sxw
            c1 = x1.to(tl.int64)[:, None] * sxw
            ly = ly[:, None]
            lx = lx[:, None]
            out_ptrs = (o_ptr + b * sob + oy.to(tl.int64) * soh + ox.to(tl.int64)[:, None] * sow
                        + c[None, :] * soc)
        else:
            # Axis 0: BLOCK_M output rows of (image, channel, output row);
            # axis 1: a block of BLOCK_N output columns, the contiguous dimension.
            rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
            ox = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
            oy = rows % Ho
            plane = rows // Ho
            c = (plane % C).to(tl.int64)
            b = (plane // C).to(tl.int64)
            y0, y1, ly = taps(oy, H, scale_h, ALIGN_CORNERS)
            x0, x1, lx = taps(ox, W, scale_w, ALIGN_CORNERS)
            mask = (b < B)[:, None] & (ox < Wo)[None, :]
            base = x_ptr + b * sxb + c * sxc
            r0 = (base + y0.to(tl.int64) * sxh)[:, None]
            r1 = (base + y1.to(tl.int64) * sxh)[:, None]
            c0 = x0.to(tl.int64)[None, :] * sxw
            c1 = x1.to(tl.int64)[None, :] * sxw
            ly = ly[:, None]
            lx = lx[None, :]
            out_ptrs = (o_ptr + (b * sob + c * soc + oy.to(tl.int64) * soh)[:, None]
                        + ox.to(tl.int64)[None, :] * sow)
        v00 = tl.load(r0 + c0, mask=mask, other=0.0).to(tl.float32)
        v01 = tl.load(r0 + c1, mask=mask, other=0.0).to(tl.float32)
        v10 = tl.load(r1 + c0, mask=mask, other=0.0).to(tl.float32)
        v11 = tl.load(r1 + c1, mask=mask, other=0.0).to(tl.float32)
        # PyTorch's order of the products and sums.
        out = (1.0 - ly) * ((1.0 - lx) * v00 + lx * v01) + ly * ((1.0 - lx) * v10 + lx * v11)
        tl.store(out_ptrs, out.to(o_ptr.dtype.element_ty), mask=mask)

    _KERNEL = bilinear_resize_kernel
    return _KERNEL


def _check(x, size, out_dtype) -> None:
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"bilinear reads and writes float32 or bfloat16 (got {x.dtype} in, "
                        f"{out_dtype} out)")
    if x.dim() != 4 or len(size) != 2 or min(size) < 1:
        raise ValueError(f"bilinear resizes (B, C, H, W) to a size (Ho, Wo) of at least 1x1 "
                         f"(got {tuple(x.shape)} to {tuple(size)})")


def source_scale(n_in: int, n_out: int, align_corners: bool) -> float:
    """The float32 step between the source coordinates of neighbouring
    output indices, as PyTorch computes it from the sizes."""
    if align_corners:
        return float(np.float32(n_in - 1) / np.float32(n_out - 1)) if n_out > 1 else 0.0
    return float(np.float32(n_in) / np.float32(n_out))


def _power_of_2(n: int) -> int:
    """The least power of two at or above n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def program_shape(c: int, wo: int, channels_last: bool, elements: int = PROGRAM[0]):
    """(BLOCK_M, BLOCK_N) of a program that writes about ``elements`` output
    elements: channels-last, BLOCK_M output pixels of a row by BLOCK_N
    channels; otherwise BLOCK_M output rows by BLOCK_N columns."""
    if channels_last:
        block_n = min(_power_of_2(c), MAX_BLOCK_C)
        return max(1, min(elements // block_n, _power_of_2(wo))), block_n
    block_n = min(_power_of_2(wo), MAX_BLOCK_W)
    return max(1, elements // block_n), block_n


def bilinear_triton(x: torch.Tensor, size: Sequence[int], align_corners: bool,
                    out_dtype: torch.dtype, program=None) -> torch.Tensor:
    """The kernel on a card: as ``bilinear_plain``, for x of any strides, in
    one launch on the current stream, without synchronising. The output is
    channels-last where x is channels-last and not also contiguous (a map
    of one channel, or of 1x1, is both and counts as contiguous), else
    contiguous. ``program`` (elements, warps) replaces ``PROGRAM`` (for
    timing others)."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"bilinear_triton needs CUDA tensors (got {x.device})")
    _check(x, size, out_dtype)
    b, c, h, w = x.shape
    ho, wo = (int(s) for s in size)
    channels_last = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    out = torch.empty((b, c, ho, wo), dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last if channels_last
                      else torch.contiguous_format)
    if out.numel() == 0:
        return out
    elements, warps = program or PROGRAM
    block_m, block_n = program_shape(c, wo, channels_last, elements)
    if channels_last:
        grid = (b * ho * -(-wo // block_m), -(-c // block_n))
    else:
        grid = (-(-b * c * ho // block_m), -(-wo // block_n))
    kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[grid](x, out, b, c, h, w, ho, wo, *x.stride(), *out.stride(),
                     source_scale(h, ho, align_corners), source_scale(w, wo, align_corners),
                     ALIGN_CORNERS=bool(align_corners), CHANNELS_LAST=channels_last,
                     BLOCK_M=block_m, BLOCK_N=block_n, num_warps=warps, num_stages=1)
    LAUNCHES += 1
    return out


def bilinear(x: torch.Tensor, size: Sequence[int], align_corners: bool,
             out_dtype: torch.dtype) -> torch.Tensor:
    """Bilinear resize of x (B, C, H, W) to ``size`` (module docstring): the
    plain version on CPU tensors; the kernel on CUDA tensors, inference
    only."""
    if not x.is_cuda:
        return bilinear_plain(x, size, align_corners, out_dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("bilinear on a card has no backward: run the forward under "
                           "torch.no_grad() or torch.inference_mode() (the models that resize "
                           "through it are served, not trained, by this port)")
    return bilinear_triton(x, size, align_corners, out_dtype)
