"""LayerNorm over the last dimension that reads its input in the input's
dtype and writes the dtype its reader takes.

For x (..., C), weight and bias (C,) float32:

    y = (x - mean(x)) / sqrt(var(x) + eps) * weight + bias

with the mean and the (biased) variance of each row, and y, in float32,
rounded to ``out_dtype`` (float32 or bfloat16) once, at the end. That is
what autocast computes around ``nn.LayerNorm``: it casts a bf16 input to
float32, normalises in float32, and the Linear or convolution that reads
the result rounds it to bf16 again.

- ``layer_norm_plain``: ``F.layer_norm`` of the input in float32 (autocast
  off), then the cast to ``out_dtype``, in plain PyTorch.
- ``layer_norm_triton``: the kernel, written in Triton and compiled at its
  first launch in a process (``triton`` is imported there, never at
  import). It replaces no TPU kernel: the JAX package's LayerNorms are
  XLA's, and this one is added because autocast makes each norm three
  passes over the rows (a cast in, the float32 norm, a cast out). Bound by
  bytes (about 8 operations an element). One pass: a program loads
  ``rows`` whole rows of C (C padded to a power of two under a mask, 16
  bytes a thread) in the input's dtype, enough rows to move about 16 KB,
  and the weight and bias once for all of them; it takes each row's mean
  and variance in float32 from registers and stores the rows in
  ``out_dtype``, rounded only there.
- ``layer_norm``: CPU tensors take the plain version; CUDA tensors launch
  the kernel or raise. The kernel has no backward: a CUDA call that
  autograd would record raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bts_tpu_torch.ops import count_launches

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
LAUNCHES = 0
count_launches(__name__, "LAUNCHES")

DTYPES = (torch.float32, torch.bfloat16)
PROGRAM_BYTES = 16384  # a program reads and writes at least about this much

_KERNEL = None


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The norm in plain PyTorch: ``F.layer_norm`` of x in float32 (autocast
    off), cast to ``out_dtype``."""
    _check(x, weight, bias, out_dtype)
    with torch.autocast(x.device.type, enabled=False):
        y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(out_dtype)


def _kernel():
    """The Triton kernel, defined at the first launch of a process."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_rows"])
    def layer_norm_kernel(x_ptr, w_ptr, b_ptr, o_ptr, n_rows, x_stride, eps,
                          C: tl.constexpr, BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_C)
        in_row = cols < C
        mask = (rows < n_rows)[:, None] & in_row[None, :]
        x = tl.load(x_ptr + rows[:, None] * x_stride + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, 1) / C
        xc = tl.where(in_row[None, :], x - mean[:, None], 0.0)
        rstd = tl.math.rsqrt(tl.sum(xc * xc, 1) / C + eps)
        w = tl.load(w_ptr + cols, mask=in_row, other=0.0)
        b = tl.load(b_ptr + cols, mask=in_row, other=0.0)
        y = xc * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(o_ptr + rows[:, None] * C + cols[None, :], y.to(o_ptr.dtype.element_ty),
                 mask=mask)

    _KERNEL = layer_norm_kernel
    return _KERNEL


def _check(x, weight, bias, out_dtype) -> None:
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"layer_norm reads and writes float32 or bfloat16 (got {x.dtype} in, "
                        f"{out_dtype} out)")
    c = x.shape[-1] if x.dim() else 0
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"layer_norm needs a float32 ({c},) {name} on {x.device} (got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device})")


def program_shape(c: int, in_bytes: int, out_bytes: int):
    """(padded C, rows a program, warps) for rows of c elements read at
    ``in_bytes`` and written at ``out_bytes`` an element."""
    block_c = _power_of_2(c)
    rows = _power_of_2(-(-PROGRAM_BYTES // (c * (in_bytes + out_bytes))))
    return block_c, rows, max(4, min(16, rows * block_c // 1024))


def _power_of_2(n: int) -> int:
    """The least power of two at or above n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def layer_norm_triton(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel on a card: as ``layer_norm_plain``, for x whose last
    dimension is contiguous and whose rows lie at one stride, in one launch
    on the current stream, without synchronising. The output is contiguous."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"layer_norm_triton needs CUDA tensors (got {x.device})")
    _check(x, weight, bias, out_dtype)
    c = x.shape[-1]
    try:
        rows = x.view(-1, c)
    except RuntimeError as err:
        raise ValueError(f"layer_norm_triton needs x's rows at one stride (got shape "
                         f"{tuple(x.shape)}, strides {x.stride()})") from err
    if rows.stride(1) != 1 or not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError("layer_norm_triton needs x's last dimension, the weight and the "
                         "bias contiguous")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    n_rows = rows.shape[0]
    if out.numel() == 0:
        return out
    block_c, per_program, warps = program_shape(c, x.element_size(), out.element_size())
    kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[(-(-n_rows // per_program),)](
            rows, weight, bias, out, n_rows, rows.stride(0), float(eps),
            C=c, BLOCK_C=block_c, ROWS=per_program, num_warps=warps, num_stages=1)
    LAUNCHES += 1
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last dimension (module docstring): the plain
    version on CPU tensors; the kernel on CUDA tensors, inference only."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("layer_norm on a card has no backward: run the forward under "
                           "torch.no_grad() or torch.inference_mode() (NeWCRFs is served, "
                           "not trained, by this port)")
    return layer_norm_triton(x, weight, bias, eps, out_dtype)
