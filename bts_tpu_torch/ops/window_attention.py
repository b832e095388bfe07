"""Shifted-window attention with a relative-position bias, read from and
written to the token grid in place.

Q, K and V are (B, h, w, heads, d) views with any strides whose last
dimension is contiguous: Swin's ``qkv`` output and the CRF levels' ``qk``
output go in as they are. A call computes, over the grid padded at the
bottom and right to window multiples Hp x Wp and rolled by (-shift,
-shift), every window w of ``window`` x ``window`` tokens (N of them; 49
for NeWCRFs's 7x7) and head h:

    O[w, :, h] = softmax(Q[w, :, h] K[w, :, h]^T * scale
                         + B_h[index] + M[w mod nW]) V[w, :, h]

Token t of window (wy, wx) sits at rolled position (r, c) = (window * wy +
t // window, window * wx + t % window); it is the grid's token ((r + shift)
mod Hp, (c + shift) mod Wp) where that lies inside h x w, and padding
otherwise. A padded token's K and V are ``k_pad`` and ``v_pad`` ((heads *
d,) rows, rounded to the inputs' dtype; None for zeros): what the Linear
that made K and V gives a row of zeros, so the result is the one the
padded, rolled and windowed copies of the grid give. Each output row goes
back to its grid token's place in O (B, h * w, heads * d), contiguous,
ready for the output projection; padded tokens' rows are not kept.
``B_h[index]`` is gathered from the bias table ((2 * window - 1)^2, heads)
by the (N, N) index buffer; ``M`` is the shifted windows' mask (nW, N, N)
over Hp x Wp, nW windows an image, or none.

- ``window_attention_reference``: the attention of windows already cut out,
  q, k, v (windows, N, heads, d), in plain PyTorch: float32 whatever the
  inputs' dtype, P rounded to the inputs' dtype before the product with V as
  the kernel rounds it; the output (windows, N, heads * d) in the inputs'
  dtype.
- ``window_attention_plain``: the grid form in plain PyTorch: every
  (window, token) gathered by its grid index (``grid_index``) or given its
  pad row, ``window_attention_reference``, the rows scattered back.
- ``window_attention_triton``: the kernel, written in Triton and compiled at
  its first launch in a process (``triton`` is imported there, never at
  import). It replaces no TPU kernel: the JAX package has no attention.
  Its work is about 24 FLOP a byte in bf16 (Q, K, V read once, O written
  once, 2 * 2 * N^2 * d operations a window and head), far under the card's
  295, so it is bound by bytes. One program computes one (window, head) in
  one pass: it gathers its tokens' Q, K and V rows (padded to 64 rows)
  from the grid into registers, takes the pad rows for padded tokens, keeps
  the scores and their softmax in float32 inside the program, accumulates
  P V in float32 on the tensor cores (bf16 inputs; float32 inputs in full
  float32), gathers the bias and reads the mask in the program, and stores
  each row at its grid token. So a block needs no padded, rolled,
  partitioned or reversed copy of its tokens.
- ``window_attention``: CPU tensors take the plain grid form; CUDA tensors
  launch the kernel or raise. The kernel has no backward: a CUDA call that
  autograd would record raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bts_tpu_torch.ops import count_launches

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
LAUNCHES = 0
count_launches(__name__, "LAUNCHES")

DTYPES = (torch.float32, torch.bfloat16)
MAX_TOKENS = 64  # a program holds a window's tokens in one 64-row tile
HEAD_DIM = 32  # every call of NeWCRFs; the only one the kernel was checked at on a card

_KERNEL = None


def padded_grid(h: int, w: int, window: int) -> Tuple[int, int]:
    """(Hp, Wp): h x w padded at the bottom and right to window multiples."""
    return -(-h // window) * window, -(-w // window) * window


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(windows, N, heads, d) -> (windows, heads, N, d) in float32."""
    return t.transpose(1, 2).float()


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               table: torch.Tensor, index: torch.Tensor,
                               mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Plain attention of cut-out windows: q, k, v (windows, N, heads, d),
    table (S, heads), index (N, N), mask (nW, N, N) or None -> (windows, N,
    heads * d) in q's dtype."""
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


def grid_index(b: int, h: int, w: int, window: int, shift: int,
               device=None) -> torch.Tensor:
    """(B * nW, N) int64: for each (window, token) of the padded grid rolled
    by (-shift, -shift), its token's row in the (B * h * w) grid, or
    B * h * w where the token is padding. Windows go image by image, row
    by row, as the kernel's programs do."""
    hp, wp = padded_grid(h, w, window)
    r = (torch.arange(hp, device=device) + shift) % hp
    c = (torch.arange(wp, device=device) + shift) % wp
    src = torch.where((r[:, None] < h) & (c[None, :] < w), r[:, None] * w + c[None, :], -1)
    src = src.view(hp // window, window, wp // window, window).transpose(1, 2)
    src = src.reshape(-1, window * window)
    rows = src[None] + h * w * torch.arange(b, device=device)[:, None, None]
    return torch.where(src[None] < 0, b * h * w, rows).reshape(-1, window * window)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor, index: torch.Tensor,
                           mask: Optional[torch.Tensor], scale: float, window: int,
                           shift: int, k_pad: Optional[torch.Tensor],
                           v_pad: Optional[torch.Tensor]) -> torch.Tensor:
    """The grid form (module docstring) in plain PyTorch: q, k, v (B, h, w,
    heads, d) -> (B, h * w, heads * d) in q's dtype."""
    _check(q, k, v, table, index, mask, window, shift, k_pad, v_pad)
    b, h, w, heads, d = q.shape
    idx = grid_index(b, h, w, window, shift, q.device)

    def gather(t, pad):
        pad = t.new_zeros(1, heads, d) if pad is None else pad.to(t.dtype).view(1, heads, d)
        return torch.cat([t.reshape(b * h * w, heads, d), pad])[idx]

    out = window_attention_reference(gather(q, None), gather(k, k_pad), gather(v, v_pad),
                                     table, index, mask, scale)
    kept = idx < b * h * w
    result = out.new_empty(b * h * w, heads * d)
    result[idx[kept]] = out[kept]
    return result.view(b, h * w, heads * d)


def _kernel():
    """The Triton kernel, defined at the first launch of a process."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["height", "width", "hp", "wp", "n_wx", "n_w", "shift",
                                   "heads"])
    def window_attn_kernel(q_ptr, k_ptr, v_ptr, o_ptr, kpad_ptr, vpad_ptr, table_ptr,
                           index_ptr, mask_ptr,
                           sqb, sqy, sqx, sqh, skb, sky, skx, skh, svb, svy, svx, svh,
                           sob, soy, sox,
                           height, width, hp, wp, n_wx, n_w, shift, heads, scale,
                           WINDOW: tl.constexpr, N: tl.constexpr, D: tl.constexpr,
                           BLOCK: tl.constexpr, HAS_MASK: tl.constexpr, K_PAD: tl.constexpr,
                           V_PAD: tl.constexpr, IEEE: tl.constexpr):
        w = tl.program_id(0)
        h = tl.program_id(1)
        img = (w // n_w).to(tl.int64)
        win = w % n_w
        rows = tl.arange(0, BLOCK)
        cols = tl.arange(0, D)
        valid = rows < N
        # Each row's grid token: its rolled position moved back by the shift.
        y = ((win // n_wx) * WINDOW + rows // WINDOW + shift) % hp
        x = ((win % n_wx) * WINDOW + rows % WINDOW + shift) % wp
        inside = valid & (y < height) & (x < width)
        pad = valid & ((y >= height) | (x >= width))
        y = y.to(tl.int64)
        x = x.to(tl.int64)
        load = inside[:, None]
        q = tl.load(q_ptr + img * sqb + h * sqh + (y * sqy + x * sqx)[:, None] + cols[None, :],
                    mask=load, other=0.0)
        k = tl.load(k_ptr + img * skb + h * skh + (y * sky + x * skx)[:, None] + cols[None, :],
                    mask=load, other=0.0)
        v = tl.load(v_ptr + img * svb + h * svh + (y * svy + x * svx)[:, None] + cols[None, :],
                    mask=load, other=0.0)
        if K_PAD:
            k = tl.where(pad[:, None], tl.load(kpad_ptr + h * D + cols).to(k.dtype)[None, :], k)
        if V_PAD:
            v = tl.where(pad[:, None], tl.load(vpad_ptr + h * D + cols).to(v.dtype)[None, :], v)
        if IEEE:
            s = tl.dot(q, tl.trans(k), input_precision="ieee")
        else:
            s = tl.dot(q, tl.trans(k))
        both = valid[:, None] & valid[None, :]
        pair = rows[:, None] * N + rows[None, :]
        idx = tl.load(index_ptr + pair, mask=both, other=0)
        s = s * scale + tl.load(table_ptr + idx * heads + h, mask=both, other=0.0)
        if HAS_MASK:
            s += tl.load(mask_ptr + win * (N * N) + pair, mask=both, other=0.0)
        s = tl.where(valid[None, :], s, float("-inf"))
        p = tl.exp(s - tl.max(s, 1)[:, None])
        p = (p / tl.sum(p, 1)[:, None]).to(v.dtype)
        if IEEE:
            o = tl.dot(p, v, input_precision="ieee")
        else:
            o = tl.dot(p, v)
        tl.store(o_ptr + img * sob + (y * soy + x * sox)[:, None] + h * D + cols[None, :],
                 o.to(o_ptr.dtype.element_ty), mask=load)

    _KERNEL = window_attn_kernel
    return _KERNEL


def _check(q, k, v, table, index, mask, window, shift, k_pad, v_pad) -> None:
    if q.dim() != 5:
        raise ValueError(f"window_attention takes q, k, v (B, h, w, heads, d) "
                         f"(got q {tuple(q.shape)})")
    b, h, w, heads, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"window_attention: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"window_attention takes float32 or bfloat16 (got {q.dtype})")
    n = window * window
    if n > MAX_TOKENS or d != HEAD_DIM or not 0 <= shift < window:
        raise ValueError(f"window_attention takes windows of up to {MAX_TOKENS} tokens, a "
                         f"head dimension of {HEAD_DIM} and 0 <= shift < window (got "
                         f"window={window}, d={d}, shift={shift})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("window_attention needs q, k and v contiguous in their last dimension")
    for name, t in (("k_pad", k_pad), ("v_pad", v_pad)):
        if t is not None and (t.shape != (heads * d,) or t.dtype not in (torch.float32, q.dtype)
                              or not t.is_contiguous()):
            raise ValueError(f"window_attention: {name} must be a contiguous ({heads * d},) "
                             f"row in float32 or {q.dtype} (got {tuple(t.shape)} {t.dtype})")
    if table.dtype != torch.float32 or table.shape[1] != heads or not table.is_contiguous():
        raise ValueError(f"window_attention needs a contiguous float32 bias table "
                         f"(S, {heads}) (got {tuple(table.shape)} {table.dtype})")
    if index.dtype != torch.int64 or index.shape != (n, n) or not index.is_contiguous():
        raise ValueError(f"window_attention needs a contiguous int64 index ({n}, {n})")
    hp, wp = padded_grid(h, w, window)
    n_w = (hp // window) * (wp // window)
    if mask is not None and (mask.dtype != torch.float32 or mask.shape != (n_w, n, n)
                             or not mask.is_contiguous()):
        raise ValueError(f"window_attention needs a contiguous float32 mask ({n_w}, {n}, {n}) "
                         f"for a {h}x{w} grid (got {tuple(mask.shape)} {mask.dtype})")
    for name, t in (("table", table), ("index", index), ("mask", mask), ("k_pad", k_pad),
                    ("v_pad", v_pad)):
        if t is not None and t.device != q.device:
            raise ValueError(f"window_attention: {name} on {t.device}, q on {q.device}")


def window_attention_triton(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            table: torch.Tensor, index: torch.Tensor,
                            mask: Optional[torch.Tensor], scale: float, window: int, shift: int,
                            k_pad: Optional[torch.Tensor],
                            v_pad: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on a card: as ``window_attention_plain``, in one launch on
    the current stream, without synchronising."""
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError(f"window_attention_triton needs CUDA tensors (got {q.device})")
    _check(q, k, v, table, index, mask, window, shift, k_pad, v_pad)
    b, h, w, heads, d = q.shape
    out = torch.empty((b, h * w, heads * d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    hp, wp = padded_grid(h, w, window)
    n_wx = wp // window
    n_w = (hp // window) * n_wx
    kernel = _kernel()
    with torch.cuda.device(q.device):
        kernel[(b * n_w, heads)](
            q, k, v, out, q if k_pad is None else k_pad, q if v_pad is None else v_pad,
            table, index, table if mask is None else mask,
            q.stride(0), q.stride(1), q.stride(2), q.stride(3),
            k.stride(0), k.stride(1), k.stride(2), k.stride(3),
            v.stride(0), v.stride(1), v.stride(2), v.stride(3),
            out.stride(0), w * out.stride(1), out.stride(1),
            h, w, hp, wp, n_wx, n_w, shift, heads, float(scale),
            WINDOW=window, N=window * window, D=d, BLOCK=MAX_TOKENS,
            HAS_MASK=mask is not None, K_PAD=k_pad is not None, V_PAD=v_pad is not None,
            IEEE=q.dtype == torch.float32, num_warps=4, num_stages=1)
    LAUNCHES += 1
    return out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
                     window: int, shift: int, k_pad: Optional[torch.Tensor],
                     v_pad: Optional[torch.Tensor]) -> torch.Tensor:
    """Window attention on the token grid (module docstring): the plain
    version on CPU tensors; the kernel on CUDA tensors, inference only."""
    if not q.is_cuda:
        return window_attention_plain(q, k, v, table, index, mask, scale, window, shift,
                                      k_pad, v_pad)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, table, k_pad, v_pad)):
        raise RuntimeError("window_attention on a card has no backward: run the forward "
                           "under torch.no_grad() or torch.inference_mode() (NeWCRFs is "
                           "served, not trained, by this port)")
    return window_attention_triton(q, k, v, table, index, mask, scale, window, shift,
                                   k_pad, v_pad)
