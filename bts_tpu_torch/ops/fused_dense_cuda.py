"""Wrappers of the hand-written CUDA fused dense layers.

The CUDA port of ``docs/archive/fused_dense.py``'s ``fused_dense_layer``
(taps) and ``fused_dense_layer_eo`` (eo): both forms in bf16 in
``csrc/fused_dense_taps_sm90.cu`` and in f32 in
``csrc/fused_dense_taps_f32_sm90.cu`` (3xTF32), all TMA + ``wgmma``. Each
wrapper checks its inputs, allocates the output with ``torch.empty`` unless
it is given one, and launches on the current stream without synchronising.
It never falls back to the plain versions in ``ops/fused_dense.py``: it
launches or raises.

The kernel reads x through its strides (channels must be contiguous), so a
channel prefix of a larger NHWC buffer, or its even / odd columns, go in
without a copy; it writes ``out`` through its strides too.
"""

from __future__ import annotations

from typing import Optional

import torch

from bts_tpu_torch.ops import _build, count_launches
from bts_tpu_torch.ops.fused_dense import pack_eo_kmajor, pack_taps_kmajor

# Kernel launches that ran in this process (``ops.LAUNCH_COUNTERS``).
TAPS_LAUNCHES = 0
EO_LAUNCHES = 0
count_launches(__name__, "TAPS_LAUNCHES", "EO_LAUNCHES")

# Both forms' kernels are built for the (Cmid, G) of DenseNet161 and
# DenseNet121.
TAPS_SHAPES = ((192, 48), (128, 32))
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_map(name, t, dt, device, vec):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dt:
        raise TypeError(f"{name} is {t.dtype}, x is {dt}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be 4-D with contiguous channels "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")
    if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: pixel strides must be multiples of {vec} elements and the "
                         f"data 16-byte aligned (16-byte loads); strides {t.stride()}")


def _check_params(dt, device, shapes, **tensors):
    for name, t in tensors.items():
        if t.device != device or t.dtype != dt:
            raise TypeError(f"{name} must be {dt} on {device} (got {t.dtype} on {t.device})")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _common(x, s1, b1, w1, s2, b2, w2, eo):
    """Checks what both forms share; the (Cmid, G) first, before the device,
    so that a shape no kernel is built for is refused on any tensor."""
    cmid = w1.shape[-1]
    g = w2.shape[-1] // 2 if eo else w2.shape[-1]
    if (cmid, g) not in TAPS_SHAPES:
        raise ValueError(f"the fused dense kernels take (Cmid, G) in {TAPS_SHAPES} "
                         f"(got {(cmid, g)})")
    if not x.is_cuda:
        raise ValueError(f"the fused dense kernel needs a CUDA tensor (got {x.device})")
    dt = x.dtype
    if dt not in _SUFFIX:
        raise TypeError(f"the fused dense kernel takes float32 or bfloat16 (got {dt})")
    vec = 16 // x.element_size()
    c = x.shape[3]
    if c % vec:
        raise ValueError(f"the fused dense kernel needs C % {vec} == 0 (got C={c})")
    w2s = (3, 4 * cmid, 2 * g) if eo else (3, 3, cmid, g)
    _check_params(dt, x.device, {"s1": (c,), "b1": (c,), "w1": (c, cmid), "s2": (cmid,),
                                 "b2": (cmid,), "w2": w2s},
                  s1=s1, b1=b1, w1=w1, s2=s2, b2=b2, w2=w2)
    return dt, vec, c, cmid, g


def _check_kmajor(kmajor, dt, device, w1t_shape, w2t_shape):
    """The K-major weights (f32: stacked TF32 halves)."""
    split = (2,) if dt == torch.float32 else ()
    w1t, w2t = kmajor
    _check_params(dt, device, {"w1t": (*split, *w1t_shape), "w2t": (*split, *w2t_shape)},
                  w1t=w1t, w2t=w2t)
    return w1t, w2t


def _run(fn, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.load_library(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")


def fused_dense_cuda(x, s1, b1, w1, s2, b2, w2, out: Optional[torch.Tensor] = None,
                     kmajor=None):
    """CUDA taps layer. x (B,H,W,C) f32/bf16 -> (B,H,W,G); parameters in
    x.dtype: s1, b1 (C,), w1 (C,Cmid), s2, b2 (Cmid,), w2 (3,3,Cmid,G).
    The kernels read w1 and w2 K-major (f32: split into TF32 halves):
    ``kmajor`` = ``pack_taps_kmajor(w1, w2)``, packed here when not given.
    They write 16-byte vectors, so ``out`` must be 16-byte aligned with pixel
    strides in multiples of 16 bytes."""
    global TAPS_LAUNCHES
    dt, vec, c, cmid, g = _common(x, s1, b1, w1, s2, b2, w2, eo=False)
    b, h, w, _ = x.shape
    _check_map("x", x, dt, x.device, vec)
    if out is None:
        out = torch.empty((b, h, w, g), dtype=dt, device=x.device)
    elif tuple(out.shape) != (b, h, w, g):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(b, h, w, g)}")
    _check_map("out", out, dt, x.device, vec)
    if kmajor is None:
        kmajor = pack_taps_kmajor(w1, w2)
    w1, w2 = _check_kmajor(kmajor, dt, x.device, (cmid, c), (3, 3, g, cmid))
    if out.numel() == 0:
        return out
    _run(f"fused_dense_taps_{_SUFFIX[dt]}", x, *x.stride()[:3], s1, b1, w1, s2, b2, w2,
         out, *out.stride()[:3], b, h, w, c, cmid, g)
    TAPS_LAUNCHES += 1
    return out


def fused_dense_eo_cuda(xe, xo, s1, b1, w1, s2, b2, w2q, out: Optional[torch.Tensor] = None,
                        kmajor=None):
    """CUDA eo layer. xe, xo (B,H,U,C) even / odd columns -> (B,H,U,2G),
    channels [0:G] the even output columns and [G:2G] the odd ones; w2q
    (3, 4*Cmid, 2G) from ``pack_w2_eo``. The kernels read w1 and w2q K-major
    (f32: split into TF32 halves): ``kmajor`` = ``pack_eo_kmajor(w1, w2q)``,
    packed here when not given. ``out`` may also be given as (B,H,U,2,G),
    e.g. a channel slice of an NHWC buffer split into column pairs; it must be
    16-byte aligned with strides in multiples of 16 bytes (16-byte stores)."""
    global EO_LAUNCHES
    dt, vec, c, cmid, g = _common(xe, s1, b1, w1, s2, b2, w2q, eo=True)
    if xe.shape != xo.shape:
        raise ValueError(f"xe {tuple(xe.shape)} and xo {tuple(xo.shape)} differ")
    b, h, u, _ = xe.shape
    _check_map("xe", xe, dt, xe.device, vec)
    _check_map("xo", xo, dt, xe.device, vec)
    if out is None:
        out = torch.empty((b, h, u, 2 * g), dtype=dt, device=xe.device)
    if tuple(out.shape) == (b, h, u, 2 * g):
        pairs = out.unflatten(3, (2, g))
    elif tuple(out.shape) == (b, h, u, 2, g):
        pairs = out
    else:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(b, h, u, 2 * g)} "
                         f"or {(b, h, u, 2, g)}")
    if pairs.device != xe.device or pairs.dtype != dt or pairs.stride(4) != 1:
        raise ValueError(f"out must be {dt} on {xe.device} with contiguous channels")
    if any(s % vec for s in pairs.stride()[:4]) or pairs.data_ptr() % 16:
        raise ValueError(f"out: strides must be multiples of {vec} elements and the data "
                         f"16-byte aligned (16-byte stores); strides {pairs.stride()}")
    if kmajor is None:
        kmajor = pack_eo_kmajor(w1, w2q)
    w1t, w2qt = _check_kmajor(kmajor, dt, xe.device, (cmid, c), (3, 2 * g, 4 * cmid))
    if out.numel() == 0:
        return out
    _run(f"fused_dense_eo_{_SUFFIX[dt]}", xe, *xe.stride()[:3], xo, *xo.stride()[:3],
         s1, b1, w1t, s2, b2, w2qt, pairs, *pairs.stride()[:4], b, h, u, c, cmid, g)
    EO_LAUNCHES += 1
    return out
