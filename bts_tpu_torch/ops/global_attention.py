"""Global multi-head self-attention over every token of an image, read
straight from the QKV projection's output.

Q, K and V are (B, N, heads, d) views with any strides whose last
dimension is contiguous: a ViT block's ``qkv`` output (B, N, 3, heads, d)
goes in as it is, ``qkv[:, :, 0]``, ``qkv[:, :, 1]``, ``qkv[:, :, 2]``.
A call computes, for every image and head h,

    O[:, h] = softmax(Q[:, h] K[:, h]^T * scale) V[:, h]

over all N tokens (no mask, no bias) and writes O as (B, N, heads * d),
contiguous, ready for the output projection.

- ``global_attention_plain``: the whole softmax of each head in plain
  PyTorch, float32 whatever the inputs' dtype, P rounded to the inputs'
  dtype before the product with V as the kernel rounds it; the output in
  the inputs' dtype.
- ``global_attention_triton``: the kernel, written in Triton and compiled
  at its first launch in a process (``triton`` is imported there, never at
  import). It replaces no TPU kernel: the JAX package has no attention; it
  is added for Depth Anything's DINOv2 ViT, whose 24 attentions over 4,737
  tokens (KITTI) are the largest single part of its forward. Its work is
  4 * N^2 * d operations a head against 8 * N * d bytes (bf16), about N/2
  operations a byte, far above the card's 295: bound by the tensor cores.
  So it never writes the N x N scores to memory: a program takes
  ``BLOCK_M`` query rows of one (image, head) and walks over the keys in
  tiles of ``BLOCK_N`` (a flash-attention forward): S = Q K^T on the tensor
  cores with float32 accumulation, an online softmax in float32 (running
  row maximum and sum, the scale and log2(e) folded into one multiply
  before ``exp2``), P rounded to the inputs' dtype, O += P V on the tensor
  cores in float32; the rows are divided by their sums once, at the end.
  Keys past N in the last tile are masked to -inf (N = 4,737 = 74 * 64 + 1
  leaves one token there), query rows past N are not stored. Float32
  inputs take the IEEE path (``input_precision="ieee"``: FMAs, no tensor
  cores), which ``cli.test``'s float32 default runs and no cell does; on an
  H100 it is slower than the plain version's cuBLAS products.
- ``global_attention``: CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise. The kernel has no backward: a CUDA call that
  autograd would record raises.
"""

from __future__ import annotations

import math

import torch

from bts_tpu_torch.ops import count_launches

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
LAUNCHES = 0
count_launches(__name__, "LAUNCHES")

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIM = 64  # DINOv2's; the only one the kernel was checked at on a card
# (BLOCK_M, BLOCK_N, warps, stages) by the inputs' dtype: the query rows a
# program holds, the keys a step, and the launch's settings; the fastest of
# those timed at the KITTI cell's call (8, 16, 4737, 64) on an H100.
CONFIGS = {torch.bfloat16: (64, 64, 4, 3), torch.float32: (64, 64, 4, 2)}

_KERNEL = None


def global_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """The attention (module docstring) in plain PyTorch: q, k, v (B, N,
    heads, d) -> (B, N, heads * d) in q's dtype."""
    _check(q, k, v)
    b, n, heads, d = q.shape
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
        p = (qh @ kh.transpose(-2, -1) * scale).softmax(-1).to(v.dtype).float()
        o = p @ vh
    return o.transpose(1, 2).reshape(b, n, heads * d).to(q.dtype)


def _kernel():
    """The Triton kernel, defined at the first launch of a process."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def attend(acc, l_i, m_i, q, k_ptrs, v_ptrs, keys, n_tokens, qk_scale,
               MASK: tl.constexpr, IEEE: tl.constexpr):
        """One tile of keys: the online softmax's step."""
        if MASK:
            valid = keys < n_tokens
            k = tl.load(k_ptrs, mask=valid[:, None], other=0.0)
        else:
            k = tl.load(k_ptrs)
        if IEEE:
            s = tl.dot(q, tl.trans(k), input_precision="ieee")
        else:
            s = tl.dot(q, tl.trans(k))
        if MASK:
            s = tl.where(valid[None, :], s, float("-inf"))
        m_new = tl.maximum(m_i, tl.max(s, 1) * qk_scale)
        p = tl.math.exp2(s * qk_scale - m_new[:, None])
        alpha = tl.math.exp2(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        if MASK:
            v = tl.load(v_ptrs, mask=valid[:, None], other=0.0)
        else:
            v = tl.load(v_ptrs)
        if IEEE:
            acc = tl.dot(p.to(v.dtype), v, acc * alpha[:, None], input_precision="ieee")
        else:
            acc = tl.dot(p.to(v.dtype), v, acc * alpha[:, None])
        return acc, l_i, m_new

    @triton.jit(do_not_specialize=["n_tokens", "heads"])
    def global_attn_kernel(q_ptr, k_ptr, v_ptr, o_ptr,
                           sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son,
                           n_tokens, heads, qk_scale,
                           D: tl.constexpr, BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                           IEEE: tl.constexpr):
        bh = tl.program_id(1)
        img = (bh // heads).to(tl.int64)
        h = (bh % heads).to(tl.int64)
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        keys = tl.arange(0, BLOCK_N)
        cols = tl.arange(0, D)
        in_rows = (rows < n_tokens)[:, None]
        q = tl.load(q_ptr + img * sqb + h * sqh + rows.to(tl.int64)[:, None] * sqn
                    + cols[None, :], mask=in_rows, other=0.0)
        k_ptrs = k_ptr + img * skb + h * skh + keys.to(tl.int64)[:, None] * skn + cols[None, :]
        v_ptrs = v_ptr + img * svb + h * svh + keys.to(tl.int64)[:, None] * svn + cols[None, :]
        m_i = tl.full((BLOCK_M,), float("-inf"), tl.float32)
        l_i = tl.zeros((BLOCK_M,), tl.float32)
        acc = tl.zeros((BLOCK_M, D), tl.float32)
        full = n_tokens // BLOCK_N * BLOCK_N
        for start in range(0, full, BLOCK_N):
            acc, l_i, m_i = attend(acc, l_i, m_i, q, k_ptrs + start * skn, v_ptrs + start * svn,
                                   keys + start, n_tokens, qk_scale, False, IEEE)
        if full < n_tokens:
            acc, l_i, m_i = attend(acc, l_i, m_i, q, k_ptrs + full * skn, v_ptrs + full * svn,
                                   keys + full, n_tokens, qk_scale, True, IEEE)
        acc = acc / l_i[:, None]
        tl.store(o_ptr + img * sob + rows.to(tl.int64)[:, None] * son + h * D + cols[None, :],
                 acc.to(o_ptr.dtype.element_ty), mask=in_rows)

    _KERNEL = global_attn_kernel
    return _KERNEL


def _check(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"global_attention takes q, k, v (B, N, heads, d) "
                         f"(got q {tuple(q.shape)})")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"global_attention: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"global_attention takes float32 or bfloat16 (got {q.dtype})")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"global_attention takes a head dimension of {HEAD_DIM} "
                         f"(got {q.shape[-1]})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("global_attention needs q, k and v contiguous in their last dimension")


def global_attention_triton(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            config=None) -> torch.Tensor:
    """The kernel on a card: as ``global_attention_plain``, in one launch on
    the current stream, without synchronising. ``config`` (BLOCK_M, BLOCK_N,
    warps, stages) replaces the dtype's ``CONFIGS`` entry (for timing
    others)."""
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError(f"global_attention_triton needs CUDA tensors (got {q.device})")
    _check(q, k, v)
    b, n, heads, d = q.shape
    out = torch.empty((b, n, heads * d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    block_m, block_n, warps, stages = config or CONFIGS[q.dtype]
    kernel = _kernel()
    with torch.cuda.device(q.device):
        kernel[(-(-n // block_m), b * heads)](
            q, k, v, out, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            n, heads, float(scale) * math.log2(math.e),
            D=d, BLOCK_M=block_m, BLOCK_N=block_n, IEEE=q.dtype == torch.float32,
            num_warps=warps, num_stages=stages)
    LAUNCHES += 1
    return out


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Global attention (module docstring): the plain version on CPU
    tensors; the kernel on CUDA tensors, inference only."""
    if not q.is_cuda:
        return global_attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("global_attention on a card has no backward: run the forward "
                           "under torch.no_grad() or torch.inference_mode() (Depth Anything "
                           "is served, not trained, by this port)")
    return global_attention_triton(q, k, v, scale)
