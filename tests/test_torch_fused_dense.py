"""bts_tpu_torch.ops.fused_dense against the archived Pallas kernels
(docs/archive/fused_dense.py, in interpret mode on the CPU), and the fused
dense-layer path of the port's DenseNet encoder."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bts_tpu_torch.models.encoders import densenet
from bts_tpu_torch.ops import fused_dense

from torch_threads import one_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_archive():
    """docs/ is not a package: load the retired kernels by file path."""
    spec = importlib.util.spec_from_file_location(
        "archived_fused_dense", os.path.join(ROOT, "docs", "archive", "fused_dense.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


archive = _load_archive()

# f32: both sides sum in f32 in another order (as docs/archive/test_fused_dense.py:82).
# bf16: y, z and out round to bf16 on both sides, but XLA may keep an
# elementwise chain in f32 between its roundings, and a one-ulp change of a
# bottleneck value (2^-8 relative) moves an output by about that much.
TOL = {np.float32: dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def make_layer(rng, b=2, h=8, w=12, c=40, cmid=24, g=8):
    """x (B,H,W,C) and folded (s1, b1, w1, s2, b2, w2), as numpy f32."""
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)

    def bn(n):
        return (rng.normal(size=n), rng.normal(size=n), rng.normal(size=n),
                rng.uniform(0.5, 2.0, n))

    s1, b1 = archive.fold_bn(*map(jnp.asarray, (a.astype(np.float32) for a in bn(c))), 1e-5)
    s2, b2 = archive.fold_bn(*map(jnp.asarray, (a.astype(np.float32) for a in bn(cmid))), 1e-5)
    w1 = (rng.normal(size=(c, cmid)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, cmid, g)) * 0.1).astype(np.float32)
    return x, tuple(np.array(a) for a in (s1, b1, w1, s2, b2, w2))


def _cast(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [jnp.asarray(a).astype(jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def test_fold_bn_matches_archive_and_batchnorm(rng):
    c = 7
    gam, bet, mean = (rng.normal(size=c).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    want_s, want_b = archive.fold_bn(*map(jnp.asarray, (gam, bet, mean, var)), 1e-5)
    s, b = fused_dense.fold_bn(*map(torch.from_numpy, (gam, bet, mean, var)), 1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-6)

    bn = nn.BatchNorm2d(c, eps=1e-5).eval()
    with torch.no_grad():
        for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (gam, bet, mean, var)):
            p.copy_(torch.from_numpy(v))
        x = torch.from_numpy(rng.normal(size=(3, c, 4, 5)).astype(np.float32))
        want = bn(x)
    got = x * s[:, None, None] + b[:, None, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pack_w2_eo_equals_archive(rng):
    w2 = rng.normal(size=(3, 3, 24, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        fused_dense.pack_w2_eo(torch.from_numpy(w2)).numpy(),
        np.asarray(archive.pack_w2_eo(jnp.asarray(w2))),
    )


@pytest.mark.parametrize("w", [12, 11], ids=["even", "odd"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
def test_taps_reference_matches_pallas(rng, dtype, w):
    x, params = make_layer(rng, w=w)
    jargs, targs = _cast((x, *params), dtype)
    want = archive.fused_dense_layer(*jargs, interpret=True)
    got = fused_dense.fused_dense_reference(*targs)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (2, 8, w, 8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
def test_eo_reference_matches_pallas(rng, dtype):
    x, params = make_layer(rng)
    w2q = np.array(archive.pack_w2_eo(jnp.asarray(params[5])))
    xe, xo = x[:, :, 0::2], x[:, :, 1::2]
    jargs, targs = _cast((xe, xo, *params[:5], w2q), dtype)
    want = archive.fused_dense_layer_eo(*jargs, interpret=True)
    got = fused_dense.fused_dense_eo_reference(*targs)
    assert tuple(got.shape) == (2, 8, 6, 16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_dispatch_taps_and_eo_agree_and_write_out(rng):
    x, params = make_layer(rng)
    xt, *pt = (torch.from_numpy(a) for a in (x, *params))
    taps = fused_dense.fused_dense_layer(xt, *pt, impl="taps")
    buf = torch.zeros(2, 8, 12, 8)
    got = fused_dense.fused_dense_layer(xt, *pt, impl="eo", out=buf)
    assert got is buf
    torch.testing.assert_close(buf, taps, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        fused_dense.fused_dense_layer(xt, *pt, impl="plain")


def test_eo_odd_width_raises(rng):
    x, params = make_layer(rng, w=11)
    with pytest.raises(ValueError, match="width 11"):
        fused_dense.fused_dense_layer(*(torch.from_numpy(a) for a in (x, *params)), impl="eo")
    enc = densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl="eo").eval()
    with torch.no_grad(), pytest.raises(ValueError, match="width 9"):
        enc(torch.zeros(1, 3, 32, 36))  # block1 at 8x9


@pytest.mark.parametrize("impl", ["taps", "eo"])
def test_fused_impls_are_inference_only(impl):
    enc = densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl=impl)
    x = torch.zeros(1, 3, 32, 32)
    with torch.no_grad(), pytest.raises(RuntimeError, match="inference-only"):
        enc.train()(x)
    with pytest.raises(RuntimeError, match="inference-only"):
        enc.eval()(x)
    enc.dense_impl = "fused"
    with torch.no_grad(), pytest.raises(ValueError, match="dense_impl"):
        enc(x)


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(m, nn.Conv2d):
                m.weight.normal_(0, 0.2, generator=gen)
    return module


@pytest.mark.parametrize("impl", ["taps", "eo"])
def test_fold_cache_follows_weights(impl):
    """A forward, then other weights loaded (and BN statistics changed in
    place): the output equals a fresh model's, not the cached fold's."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 3, 32, 64)).astype(np.float32))
    enc = _randomize(densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl=impl), 0).eval()
    other = _randomize(densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl=impl), 1).eval()
    with torch.no_grad():
        before = enc(x)
        enc.load_state_dict(other.state_dict())
        got, want = enc(x), other(x)
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not torch.equal(got[-1], before[-1])
        enc.base_model.denseblock1.denselayer1.norm1.running_mean.add_(0.5)
        other.base_model.denseblock1.denselayer1.norm1.running_mean.add_(0.5)
        for g, w in zip(enc(x), other(x), strict=True):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        # The kernels' K-major weights are refolded with the rest.
        layer = enc.base_model.denseblock1.denselayer2
        before = layer.folded(torch.float32, impl == "eo")[7]
        layer.conv2.weight.mul_(2.0)
        _, _, w1, _, _, w2, w2q, kmajor = layer.folded(torch.float32, impl == "eo")
        want = (fused_dense.pack_eo_kmajor(w1, w2q) if impl == "eo"
                else fused_dense.pack_taps_kmajor(w1, w2))
        for got, new in zip(kmajor, want, strict=True):
            torch.testing.assert_close(got, new, rtol=0, atol=0)
        assert not torch.equal(kmajor[1], before[1])


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    from bts_tpu_torch.ops import fused_dense_cuda

    x, params = make_layer(rng, c=16, cmid=128, g=32)
    xt, *pt = (torch.from_numpy(a) for a in (x, *params))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_dense_cuda.fused_dense_cuda(xt, *pt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_dense_cuda.fused_dense_eo_cuda(
            xt[:, :, 0::2], xt[:, :, 1::2], *pt[:5], fused_dense.pack_w2_eo(pt[5]))
    assert fused_dense_cuda.TAPS_LAUNCHES == fused_dense_cuda.EO_LAUNCHES == 0


def test_weights_made_under_inference_mode_fold_each_call():
    """Inference tensors carry no version counter: no cache, same result."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 3, 32, 32)).astype(np.float32))
    with torch.inference_mode():
        enc = _randomize(densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl="taps"), 2).eval()
        want = densenet.DenseNetEncoder((2, 2), 8, 16, dense_impl="plain").eval()
        want.load_state_dict(enc.state_dict())
        for _ in range(2):
            for g, w in zip(enc(x), want(x), strict=True):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,eo", [(torch.bfloat16, False), (torch.bfloat16, True),
                                      (torch.float32, False), (torch.float32, True)])
def test_folded_packs_kmajor_for_the_bf16_taps_kernel(dtype, eo):
    """The kernels read both kernels K-major: w1t is conv1's own (Cmid, C)
    layout, and w2t conv2's taps as (3, 3, G, Cmid) for taps or pack_w2_eo's
    kernel as (3, 2G, 4*Cmid) for eo; in f32 each is stacked as its TF32
    halves (big, small)."""
    layer = _randomize(densenet.DenseLayer(40, 8), 3).eval()
    s1, b1, w1, s2, b2, w2, w2q, kmajor = layer.folded(dtype, eo)
    w1t, w2t = kmajor
    assert w1t.is_contiguous() and w2t.is_contiguous() and w1t.dtype == w2t.dtype == dtype
    want1 = layer.conv1.weight[:, :, 0, 0].to(dtype)
    want2 = layer.conv2.weight.permute(2, 3, 0, 1).to(dtype)
    if eo:
        want2 = fused_dense.pack_w2_eo(layer.conv2.weight.permute(2, 3, 1, 0).to(dtype))
        want2 = want2.transpose(1, 2)
        assert tuple(want2.shape) == (3, 16, 128)
    if dtype == torch.float32:
        assert tuple(w1t.shape) == (2, 32, 40)
        assert tuple(w2t.shape) == ((2, 3, 16, 128) if eo else (2, 3, 3, 8, 32))
        for got, want in ((w1t, want1), (w2t, want2)):
            torch.testing.assert_close(got[0], fused_dense.tf32_round(want), rtol=0, atol=0)
            torch.testing.assert_close(got[0] + got[1], want, rtol=2.0**-21, atol=0)
    else:
        torch.testing.assert_close(w1t, want1, rtol=0, atol=0)
        torch.testing.assert_close(w2t, want2, rtol=0, atol=0)
    pack = (fused_dense.pack_eo_kmajor(w1, w2q) if eo
            else fused_dense.pack_taps_kmajor(w1, w2))
    assert tuple(map(torch.Tensor.tolist, pack)) == (w1t.tolist(), w2t.tolist())
    assert layer.folded(dtype, eo)[7] is kmajor  # cached


def test_tf32_split_halves(rng):
    """big keeps 10 mantissa bits (its 13 low bits are zero), rounded to
    nearest with ties away from zero, and big + small recovers the f32 value
    to 2^-22 relative."""
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096)).astype(np.float32)
    # Ties: low 13 bits exactly 0x1000, both signs.
    ties = (np.array([0x3F801000, 0x3F803000, 0xBF801000], dtype=np.uint32)).view(np.float32)
    a = np.concatenate([a, ties, np.float32([0.0, 1.0, -2.5])])
    big, small = fused_dense.tf32_split(torch.from_numpy(a))
    for half in (big, small):
        assert not (half.numpy().view(np.uint32) & 0x1FFF).any()
    bits = a.view(np.uint32)
    mag = (bits & 0x7FFFFFFF).astype(np.uint64)
    want = ((mag + 0x1000) & ~np.uint64(0x1FFF)).astype(np.uint32) | (bits & 0x80000000)
    np.testing.assert_array_equal(big.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(big.numpy()[-6:-3].view(np.uint32),
                                  np.array([0x3F802000, 0x3F804000, 0xBF802000], np.uint32))
    err = np.abs((big.double() + small.double()).numpy() - a.astype(np.float64))
    assert (err <= 2.0**-22 * np.abs(a)).all()


def _mm_3xtf32(a, b):
    """a @ b as the f32 taps kernel forms it: three products of TF32 halves,
    small.big + big.small + big.big, summed in f32."""
    ab, as_ = fused_dense.tf32_split(a)
    bb, bs = fused_dense.tf32_split(b)
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def _taps_3xtf32(x, s1, b1, w1, s2, b2, w2, mm=_mm_3xtf32):
    """The f32 taps kernel's arithmetic in plain PyTorch (for these tests
    only): y, z and out at the reference's rounding points, both products
    through ``mm``."""
    _, h, w, _ = x.shape
    y = torch.relu(x * s1 + b1)
    z = torch.nn.functional.pad(torch.relu(mm(y, w1) * s2 + b2), (0, 0, 1, 1, 1, 1))
    acc = None
    for dh in range(3):
        for dw in range(3):
            part = mm(z[:, dh:dh + h, dw:dw + w].contiguous(), w2[dh, dw])
            acc = part if acc is None else acc + part
    return acc


def _eo_3xtf32(xe, xo, s1, b1, w1, s2, b2, w2q, mm=_mm_3xtf32, split=2):
    """The f32 eo kernel's arithmetic in plain PyTorch (for these tests
    only): the bottleneck as in ``_taps_3xtf32``; per dh, the product of
    [zo[u-1], ze[u], zo[u], ze[u+1]] with w2q[dh] over each CTA's share of
    the channels (``split`` of them), one 32-channel K block (a ring slot)
    at a time, each slot's product promoted into an f32 sum; the 3 x split
    partial sums added at the end."""
    _, h, u, _ = xe.shape
    cmid = w1.shape[1]

    def bottleneck(x):
        y = torch.relu(x * s1 + b1)
        return torch.nn.functional.pad(torch.relu(mm(y, w1) * s2 + b2), (0, 0, 1, 1, 1, 1))

    ze, zo = bottleneck(xe), bottleneck(xo)
    taps = (zo[:, :, 0:u], ze[:, :, 1:u + 1], zo[:, :, 1:u + 1], ze[:, :, 2:u + 2])
    out = 0
    share = cmid // split
    for rank in range(split):
        for dh in range(3):
            part = 0
            for blk, tap in enumerate(taps):
                for c0 in range(rank * share, (rank + 1) * share, 32):
                    k0 = blk * cmid + c0
                    part = part + mm(tap[:, dh:dh + h, :, c0:c0 + 32].contiguous(),
                                     w2q[dh, k0:k0 + 32])
            out = out + part
    return out


@pytest.mark.parametrize("c,cmid,g,form", [(96, 192, 48, "taps"), (2160, 192, 48, "taps"),
                                           (1024, 128, 32, "taps"), (2160, 192, 48, "eo")],
                         ids=["96-192-48", "2160-192-48", "1024-128-32", "eo-2160-192-48"])
def test_3xtf32_products_hold_the_f32_tolerance(rng, c, cmid, g, form):
    """The numerics of the f32 kernels: 3xTF32 products stay within the
    f32 tolerance (rtol/atol 1e-4) of fused_dense_reference (eo:
    fused_dense_eo_reference, K = 4*Cmid per dh, promoted per slot) at
    DenseNet's widths; one TF32 product alone would be an order of magnitude
    further."""
    x, params = make_layer(rng, b=1, h=4, w=6 if form == "eo" else 5, c=c, cmid=cmid, g=g)
    xt, *pt = (torch.from_numpy(a) for a in (x, *params))
    one_tf32 = lambda a, b: torch.matmul(fused_dense.tf32_round(a), fused_dense.tf32_round(b))
    if form == "eo":
        args = (xt[:, :, 0::2], xt[:, :, 1::2], *pt[:5], fused_dense.pack_w2_eo(pt[5]))
        want = fused_dense.fused_dense_eo_reference(*args)
        got, one = _eo_3xtf32(*args), _eo_3xtf32(*args, mm=one_tf32)
    else:
        want = fused_dense.fused_dense_reference(xt, *pt)
        got, one = _taps_3xtf32(xt, *pt), _taps_3xtf32(xt, *pt, mm=one_tf32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (one - want).abs().max() > 10 * (got - want).abs().max()


def test_pack_eo_kmajor_is_w2q_transposed(rng):
    """pack_eo_kmajor: w1 (C, Cmid) -> (Cmid, C) and w2q (3, 4*Cmid, 2G) ->
    (3, 2G, 4*Cmid), contiguous; in f32 stacked as (big, small) =
    tf32_split of each, bit for bit."""
    _, params = make_layer(rng, c=40, cmid=32, g=8)
    w1 = torch.from_numpy(params[2])
    w2q = fused_dense.pack_w2_eo(torch.from_numpy(params[5]))
    for dtype in (torch.bfloat16, torch.float32):
        w1t, w2qt = fused_dense.pack_eo_kmajor(w1.to(dtype), w2q.to(dtype))
        assert w1t.is_contiguous() and w2qt.is_contiguous()
        want1, want2 = w1.to(dtype).t(), w2q.to(dtype).transpose(1, 2)
        if dtype == torch.bfloat16:
            assert tuple(w2qt.shape) == (3, 16, 128)
            torch.testing.assert_close(w1t, want1, rtol=0, atol=0)
            torch.testing.assert_close(w2qt, want2, rtol=0, atol=0)
            continue
        assert tuple(w1t.shape) == (2, 32, 40) and tuple(w2qt.shape) == (2, 3, 16, 128)
        for got, want in ((w1t, want1), (w2qt, want2)):
            big, small = fused_dense.tf32_split(want.contiguous())
            assert torch.equal(got[0], big) and torch.equal(got[1], small)


# The eo kernels' tile geometry (csrc/fused_dense_taps_sm90.cu and
# csrc/fused_dense_taps_f32_sm90.cu): 8 rows x 8 column pairs, a halo of 10
# rows x 9 entries per parity, ze's box at row 0 and zo's at row 96.
EO_PAIRS, EO_W, EO_ODD_ROW, EO_ROWS = 8, 9, 96, 192


def _eo_tiles_emulated(xe, xo, s1, b1, w1, s2, b2, w2q):
    """fused_dense_eo's output computed as the eo kernels address it, tile
    by tile, in f32 numpy: each tile's two parity boxes (zero fill outside
    the image, zo's box starting at u0 - 1), stage 1 over all 192 rows with
    the per-row out-of-image mask, and stage 2's A rows for blocks 0-3 per
    dh. Returns the output and the tiles' origins (b, oy0, u0)."""
    bsz, h, u, c = xe.shape
    cmid, g2 = w1.shape[1], w2q.shape[2]
    out = np.full((bsz, h, u, g2), np.nan, np.float32)
    tiles = []
    for b in range(bsz):
        for oy0 in range(0, h, 8):
            for u0 in range(0, u, EO_PAIRS):
                tiles.append((b, oy0, u0))
                slot = np.zeros((EO_ROWS, c), np.float32)
                inside = np.zeros(EO_ROWS, bool)
                for odd, (x, first) in enumerate(((xe, u0), (xo, u0 - 1))):
                    for i in range(10 * EO_W):
                        gy, gu = oy0 - 1 + i // EO_W, first + i % EO_W
                        r = odd * EO_ODD_ROW + i
                        if 0 <= gy < h and 0 <= gu < u:
                            slot[r] = x[b, gy, gu]
                            inside[r] = True
                y = np.maximum(slot * s1 + b1, 0)  # the TMA's zeros go through BN1
                z = np.maximum((y @ w1) * s2 + b2, 0) * inside[:, None]
                for m in range(64):
                    ty, tu = divmod(m, EO_PAIRS)
                    if oy0 + ty >= h or u0 + tu >= u:
                        continue
                    acc = np.zeros(g2, np.float32)
                    for dh in range(3):
                        rows = [(EO_ODD_ROW if blk % 2 == 0 else 0) + (ty + dh) * EO_W + tu
                                + blk // 2 for blk in range(4)]
                        acc += np.concatenate([z[r] for r in rows]) @ w2q[dh]
                    out[b, oy0 + ty, u0 + tu] = acc
    return out, tiles


@pytest.mark.parametrize("h,u", [(11, 10), (8, 8), (17, 3)])
def test_eo_kernel_addressing_matches_reference(rng, h, u):
    """The eo kernels' addressing, emulated tile by tile in numpy, equals
    fused_dense_eo_reference in f32: left-edge tiles (zo's box starts at
    u0 - 1 = -1), right-edge tiles with a ragged U (10 = 8 + 2 pairs), and
    top and bottom edges (ragged H)."""
    x, params = make_layer(rng, b=2, h=h, w=2 * u, c=16, cmid=24, g=8)
    s1, b1, w1, s2, b2, w2 = params
    w2q = np.array(archive.pack_w2_eo(jnp.asarray(w2)))
    xe, xo = x[:, :, 0::2], x[:, :, 1::2]
    got, tiles = _eo_tiles_emulated(xe, xo, s1, b1, w1, s2, b2, w2q)
    want = fused_dense.fused_dense_eo_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (xe, xo, s1, b1, w1, s2, b2, w2q)))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    assert {u0 for _, _, u0 in tiles} == set(range(0, u, EO_PAIRS))
    assert len({oy0 for _, oy0, _ in tiles}) == -(-h // 8)


@pytest.mark.parametrize("eo", [False, True], ids=["taps", "eo"])
def test_kernel_wrappers_refuse_shapes_without_a_kernel(rng, eo):
    """Both forms' kernels are built for (Cmid, G) in TAPS_SHAPES; any other
    is refused before the device is looked at, so also on the CPU."""
    from bts_tpu_torch.ops import fused_dense_cuda

    x, params = make_layer(rng, c=16, cmid=64, g=16)
    xt, *pt = (torch.from_numpy(a) for a in (x, *params))
    with pytest.raises(ValueError, match=r"\(Cmid, G\) in .*got \(64, 16\)"):
        if eo:
            fused_dense_cuda.fused_dense_eo_cuda(
                xt[:, :, 0::2], xt[:, :, 1::2], *pt[:5], fused_dense.pack_w2_eo(pt[5]))
        else:
            fused_dense_cuda.fused_dense_cuda(xt, *pt)
    assert (64, 16) not in fused_dense_cuda.TAPS_SHAPES
    assert fused_dense_cuda.TAPS_LAUNCHES == fused_dense_cuda.EO_LAUNCHES == 0
