"""Window attention with a relative-position bias: one launch computes, for
every window w and head h of a call,

    O[w, :, h] = softmax(Q[w, :, h] K[w, :, h]^T * scale
                         + B_h[index] + M[w mod nW]) V[w, :, h]

over the N tokens of a window (49 for Swin's 7x7 windows) and a head
dimension d (32 in every call of NeWCRFs). ``B_h[index]`` is gathered from
the bias table ((2*ws-1)^2, heads) by the window's index buffer (N, N);
``M`` is the shifted windows' mask (nW, N, N), or none. Q, K and V are
(windows, N, heads, d) views with any strides whose last dimension is
contiguous, so Swin's ``qkv`` output goes in without a copy; O is
(windows, N, heads * d), contiguous, ready for the output projection.

- ``window_attention_reference``: the plain PyTorch version, in float32
  whatever the inputs' dtype, P rounded to the inputs' dtype before the
  product with V as the kernel rounds it; the output in the inputs' dtype.
- ``window_attention_triton``: the kernel, written in Triton and compiled at
  its first launch in a process (``triton`` is imported there, never at
  import). It replaces no TPU kernel: the JAX package has no attention.
  Its work is about 24 FLOP a byte in bf16 (Q, K, V read once, O written
  once, 2 * 2 * N^2 * d operations a window and head), far under the card's
  295, so it is bound by bytes. One program computes one (window, head) in
  one pass: Q, K and V (padded to 64 rows) go to registers once, the scores
  and their softmax in float32 never leave the program, and P V is
  accumulated in float32 on the tensor cores (bf16 inputs; float32 inputs
  in full float32), the bias and the mask gathered in the program.
- ``window_attention``: CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise. The kernel has no backward: a CUDA call that
  autograd would record raises.
"""

from __future__ import annotations

from typing import Optional

import torch

# Kernel launches that ran in this process: bumped here once per launch, and
# by a CUDA graph's replay (models/graphed.py) for the launches its capture
# recorded; a capture itself runs nothing and counts nothing.
LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16)
MAX_TOKENS = 64  # a program holds a window's tokens in one 64-row tile
HEAD_DIM = 32  # every call of NeWCRFs; the only one the kernel was checked at on a card

_KERNEL = None


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(windows, N, heads, d) -> (windows, heads, N, d) in float32."""
    return t.transpose(1, 2).float()


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               table: torch.Tensor, index: torch.Tensor,
                               mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Plain version: q, k, v (windows, N, heads, d), table (S, heads),
    index (N, N), mask (nW, N, N) or None -> (windows, N, heads * d) in
    q's dtype."""
    windows, n, heads, d = q.shape
    with torch.autocast(q.device.type, enabled=False):
        s = _heads(q) @ _heads(k).transpose(-2, -1) * scale
        s = s + table.float()[index.reshape(-1)].view(n, n, heads).permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            s = (s.view(windows // nw, nw, heads, n, n) + mask.float()[None, :, None]).view(
                windows, heads, n, n)
        p = s.softmax(-1).to(v.dtype).float()
        o = p @ _heads(v)
    return o.transpose(1, 2).reshape(windows, n, heads * d).to(q.dtype)


def _kernel():
    """The Triton kernel, defined at the first launch of a process."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["heads", "n_mask"])
    def window_attn_kernel(q_ptr, k_ptr, v_ptr, o_ptr, table_ptr, index_ptr, mask_ptr,
                           sqw, sqt, sqh, skw, skt, skh, svw, svt, svh, sow, sot,
                           heads, n_mask, scale,
                           N: tl.constexpr, D: tl.constexpr, BLOCK: tl.constexpr,
                           HAS_MASK: tl.constexpr, IEEE: tl.constexpr):
        w = tl.program_id(0).to(tl.int64)
        h = tl.program_id(1)
        rows = tl.arange(0, BLOCK)
        cols = tl.arange(0, D)
        valid = rows < N
        both = valid[:, None] & valid[None, :]
        q = tl.load(q_ptr + w * sqw + h * sqh + rows[:, None] * sqt + cols[None, :],
                    mask=valid[:, None], other=0.0)
        k = tl.load(k_ptr + w * skw + h * skh + rows[:, None] * skt + cols[None, :],
                    mask=valid[:, None], other=0.0)
        v = tl.load(v_ptr + w * svw + h * svh + rows[:, None] * svt + cols[None, :],
                    mask=valid[:, None], other=0.0)
        if IEEE:
            s = tl.dot(q, tl.trans(k), input_precision="ieee")
        else:
            s = tl.dot(q, tl.trans(k))
        pair = rows[:, None] * N + rows[None, :]
        idx = tl.load(index_ptr + pair, mask=both, other=0)
        s = s * scale + tl.load(table_ptr + idx * heads + h, mask=both, other=0.0)
        if HAS_MASK:
            s += tl.load(mask_ptr + (w % n_mask) * (N * N) + pair, mask=both, other=0.0)
        s = tl.where(valid[None, :], s, float("-inf"))
        p = tl.exp(s - tl.max(s, 1)[:, None])
        p = (p / tl.sum(p, 1)[:, None]).to(v.dtype)
        if IEEE:
            o = tl.dot(p, v, input_precision="ieee")
        else:
            o = tl.dot(p, v)
        tl.store(o_ptr + w * sow + rows[:, None] * sot + h * D + cols[None, :],
                 o.to(o_ptr.dtype.element_ty), mask=valid[:, None])

    _KERNEL = window_attn_kernel
    return _KERNEL


def _check(q, k, v, table, index, mask) -> None:
    windows, n, heads, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"window_attention: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"window_attention takes float32 or bfloat16 (got {q.dtype})")
    if n > MAX_TOKENS or d != HEAD_DIM:
        raise ValueError(f"window_attention takes up to {MAX_TOKENS} tokens and a head "
                         f"dimension of {HEAD_DIM} (got N={n}, d={d})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("window_attention needs q, k and v contiguous in their last dimension")
    if table.dtype != torch.float32 or table.shape[1] != heads or not table.is_contiguous():
        raise ValueError(f"window_attention needs a contiguous float32 bias table "
                         f"(S, {heads}) (got {tuple(table.shape)} {table.dtype})")
    if index.dtype != torch.int64 or index.shape != (n, n) or not index.is_contiguous():
        raise ValueError(f"window_attention needs a contiguous int64 index ({n}, {n})")
    if mask is not None and (mask.dtype != torch.float32 or mask.shape[1:] != (n, n)
                             or not mask.is_contiguous() or windows % mask.shape[0]):
        raise ValueError(f"window_attention needs a contiguous float32 mask (nW, {n}, {n}) "
                         f"whose nW divides {windows} windows (got {tuple(mask.shape)})")
    for name, t in (("table", table), ("index", index), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"window_attention: {name} on {t.device}, q on {q.device}")


def window_attention_triton(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            table: torch.Tensor, index: torch.Tensor,
                            mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """The kernel on a card: as ``window_attention_reference``, in one
    launch on the current stream, without synchronising."""
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError(f"window_attention_triton needs CUDA tensors (got {q.device})")
    _check(q, k, v, table, index, mask)
    windows, n, heads, d = q.shape
    out = torch.empty((windows, n, heads * d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(q.device):
        kernel[(windows, heads)](
            q, k, v, out, table, index, table if mask is None else mask,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            heads, 1 if mask is None else mask.shape[0], float(scale),
            N=n, D=d, BLOCK=MAX_TOKENS, HAS_MASK=mask is not None,
            IEEE=q.dtype == torch.float32, num_warps=4, num_stages=1)
    LAUNCHES += 1
    return out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, mask: Optional[torch.Tensor],
                     scale: float) -> torch.Tensor:
    """Window attention (module docstring): the plain version on CPU
    tensors; the kernel on CUDA tensors, inference only."""
    if not q.is_cuda:
        return window_attention_reference(q, k, v, table, index, mask, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, table)):
        raise RuntimeError("window_attention on a card has no backward: run the forward "
                           "under torch.no_grad() or torch.inference_mode() (NeWCRFs is "
                           "served, not trained, by this port)")
    return window_attention_triton(q, k, v, table, index, mask, scale)
