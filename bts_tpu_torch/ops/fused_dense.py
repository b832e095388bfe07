"""Fused DenseNet layer for inference: plain PyTorch versions and the dispatch.

Port of the retired Pallas kernels in ``docs/archive/fused_dense.py``. One
torchvision dense layer in eval mode, with both BatchNorms folded to a
per-channel scale and bias (``fold_bn``):

    y   = dt(relu(x*s1 + b1))      s1, b1 rounded to dt first
    t   = f32(sum_C y*w1)          1x1 conv, f32 accumulation
    z   = dt(relu(t*s2 + b2))      the 4g-wide bottleneck, zero-padded by 1
    out = dt(sum_{3x3 taps} z*w2)  f32 accumulation

with dt the input dtype. Layout is the Pallas kernels' (NHWC): x (B,H,W,C),
w1 (C,Cmid), w2 (3,3,Cmid,G), out (B,H,W,G). The padding of the 3x3 is on
``z``: a pixel outside the image contributes 0, not the bottleneck of a zero
input.

Two forms of the same layer (``impl``):
  - ``taps``: nine shifted (Cmid, G) products (``fused_dense_layer`` :167);
  - ``eo``: the feature map as its even and odd W-columns, with the 3x3
    packed into a (3, 4*Cmid, 2G) kernel (``pack_w2_eo``) so one product
    emits both columns of a pair (``fused_dense_layer_eo`` :216). It needs
    an even width.

``fused_dense_layer`` takes the plain version for a CPU tensor and the CUDA
kernel (``ops/fused_dense_cuda.py``) for a CUDA tensor; there is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IMPLS = ("taps", "eo")

# (tap block of the lane-concat [zo[u-1], ze[u], zo[u], ze[u+1]], output
# column half (0 even, 1 odd), dw of the 3x3 kernel): pack_w2_eo's table.
_EO_BLOCKS = ((0, 0, 0), (1, 0, 1), (2, 0, 2), (1, 1, 0), (2, 1, 1), (3, 1, 2))


def fold_bn(scale, bias, mean, var, eps):
    """Fold BatchNorm (inference) into per-channel (mul, add)."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


def pack_w2_eo(w2: torch.Tensor) -> torch.Tensor:
    """Repack a (3, 3, Cmid, G) kernel for the parity split: (3, 4*Cmid, 2G).

    Row blocks follow the lane-concat [zo[u-1], ze[u], zo[u], ze[u+1]];
    column halves are the (even, odd) output columns (2u, 2u+1).
    """
    kh, kw, cmid, g = w2.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_w2_eo needs a (3,3,Cmid,G) kernel (got {tuple(w2.shape)})")
    w2q = w2.new_zeros((3, 4 * cmid, 2 * g))
    for blk, col, dw in _EO_BLOCKS:
        w2q[:, blk * cmid:(blk + 1) * cmid, col * g:(col + 1) * g] = w2[:, dw]
    return w2q


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits; the 13 low bits zero) to
    nearest, ties away from zero: PTX's ``cvt.rna.tf32.f32``."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor):
    """(big, small) with big = tf32(a) and small = tf32(a - big): the two
    TF32 halves of an f32 operand for the 3xTF32 products (big*big +
    big*small + small*big) of the f32 taps kernel."""
    big = tf32_round(a)
    return big, tf32_round(a - big)


def _split_f32(w1t: torch.Tensor, w2t: torch.Tensor):
    """In f32, each K-major kernel stacked as its ``tf32_split`` ([0] big, [1]
    small); in bf16 the two as they are."""
    if w1t.dtype == torch.float32:
        return torch.stack(tf32_split(w1t)), torch.stack(tf32_split(w2t))
    return w1t, w2t


def pack_taps_kmajor(w1: torch.Tensor, w2: torch.Tensor):
    """(w1t, w2t): the two kernels with K contiguous, as the taps kernels
    read their wgmma B operands: w1 (C, Cmid) -> (Cmid, C), w2 (3, 3, Cmid, G)
    -> (3, 3, G, Cmid). In f32 each is stacked as its ``tf32_split``:
    (2, Cmid, C) and (2, 3, 3, G, Cmid), [0] big and [1] small."""
    return _split_f32(w1.t().contiguous(), w2.permute(0, 1, 3, 2).contiguous())


def pack_eo_kmajor(w1: torch.Tensor, w2q: torch.Tensor):
    """(w1t, w2qt): the eo kernels' wgmma B operands with K contiguous: w1
    (C, Cmid) -> (Cmid, C), w2q (3, 4*Cmid, 2G) -> (3, 2G, 4*Cmid). In f32
    each is stacked as its ``tf32_split``: (2, Cmid, C) and (2, 3, 2G,
    4*Cmid), [0] big and [1] small."""
    return _split_f32(w1.t().contiguous(), w2q.transpose(1, 2).contiguous())


def _bottleneck(x, s1, b1, w1, s2, b2) -> torch.Tensor:
    """relu(bn1) -> 1x1 (f32 sum) -> relu(bn2), zero-padded by 1 in H and W;
    float32 holding dt values."""
    dt = x.dtype
    y = torch.relu(x * s1.to(dt) + b1.to(dt))
    t = torch.matmul(y.float(), w1.to(dt).float())
    z = torch.relu(t * s2.to(dt).float() + b2.to(dt).float()).to(dt)
    return F.pad(z.float(), (0, 0, 1, 1, 1, 1))


def fused_dense_reference(x, s1, b1, w1, s2, b2, w2) -> torch.Tensor:
    """Plain 'taps' layer: x (B,H,W,C) -> (B,H,W,G) in x.dtype."""
    _, h, w, _ = x.shape
    z = _bottleneck(x, s1, b1, w1, s2, b2)
    w2f = w2.to(x.dtype).float()
    acc = None
    for dh in range(3):
        for dw in range(3):
            part = torch.matmul(z[:, dh:dh + h, dw:dw + w], w2f[dh, dw])
            acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def fused_dense_eo_reference(xe, xo, s1, b1, w1, s2, b2, w2q) -> torch.Tensor:
    """Plain 'eo' layer: xe, xo (B,H,U,C) even / odd W-columns ->
    (B,H,U,2G), channels [0:G] the even output columns, [G:2G] the odd."""
    if xe.shape != xo.shape:
        raise ValueError(f"xe {tuple(xe.shape)} and xo {tuple(xo.shape)} differ")
    _, h, u, _ = xe.shape
    cmid = w1.shape[1]
    ze = _bottleneck(xe, s1, b1, w1, s2, b2)
    zo = _bottleneck(xo, s1, b1, w1, s2, b2)
    taps = (zo[:, :, 0:u], ze[:, :, 1:u + 1], zo[:, :, 1:u + 1], ze[:, :, 2:u + 2])
    w2qf = w2q.to(xe.dtype).float()
    acc = None
    for dh in range(3):
        for blk, tap in enumerate(taps):
            part = torch.matmul(tap[:, dh:dh + h], w2qf[dh, blk * cmid:(blk + 1) * cmid])
            acc = part if acc is None else acc + part
    return acc.to(xe.dtype)


def fused_dense_layer(
    x: torch.Tensor, s1, b1, w1, s2, b2, w2,
    impl: str = "taps",
    w2q: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    kmajor=None,
) -> torch.Tensor:
    """One dense layer, x (B,H,W,C) -> (B,H,W,G), by ``impl`` taps or eo.

    A CPU tensor takes the plain version; a CUDA tensor the kernel, which
    raises on what it cannot take. ``w2q`` is ``pack_w2_eo(w2)``, computed
    here when not given; ``kmajor`` is the kernel's K-major weights,
    ``pack_taps_kmajor(w1, w2)`` for taps or ``pack_eo_kmajor(w1, w2q)`` for
    eo, computed by the kernel's wrapper when not given. ``out`` (B,H,W,G), when
    given, receives the result (the kernel writes it in place: it may be a
    channel slice of a larger NHWC buffer) and is returned.
    """
    if impl not in IMPLS:
        raise ValueError(f"fused dense impl must be one of {'/'.join(IMPLS)} (got {impl!r})")
    b, h, w, _ = x.shape
    g = w2.shape[3]
    if impl == "eo":
        if w % 2:
            raise ValueError(
                f"dense_impl 'eo' needs an even width at every dense block (got width {w})"
            )
        if w2q is None:
            w2q = pack_w2_eo(w2)
    if x.device.type == "cpu":
        if impl == "taps":
            res = fused_dense_reference(x, s1, b1, w1, s2, b2, w2)
        else:
            res = fused_dense_eo_reference(
                x[:, :, 0::2], x[:, :, 1::2], s1, b1, w1, s2, b2, w2q
            ).reshape(b, h, w, g)
        if out is None:
            return res
        return out.copy_(res)

    from bts_tpu_torch.ops import fused_dense_cuda

    if impl == "taps":
        return fused_dense_cuda.fused_dense_cuda(x, s1, b1, w1, s2, b2, w2, out=out,
                                                 kmajor=kmajor)
    if out is None:
        out = torch.empty((b, h, w, g), dtype=x.dtype, device=x.device)
    fused_dense_cuda.fused_dense_eo_cuda(
        x[:, :, 0::2], x[:, :, 1::2], s1, b1, w1, s2, b2, w2q, out=out.unflatten(2, (w // 2, 2)),
        kmajor=kmajor,
    )
    return out
