"""bts_tpu_torch.ops.lpg (plain PyTorch) against bts_tpu.ops.lpg and the
Pallas kernel in interpret mode, on the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.ops import lpg as jlpg
from bts_tpu.ops.lpg_pallas import lpg_pallas
from bts_tpu_torch.ops import _build, lpg_cuda
from bts_tpu_torch.ops import lpg as tlpg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_plane_eq(rng, b=2, h=4, w=6):
    theta = rng.uniform(0.05, np.pi / 3, size=(b, h, w))
    phi = rng.uniform(0, 2 * np.pi, size=(b, h, w))
    dist = rng.uniform(0.5, 10.0, size=(b, h, w))
    n1 = np.sin(theta) * np.cos(phi)
    n2 = np.sin(theta) * np.sin(phi)
    n3 = np.cos(theta)
    return np.stack([n1, n2, n3, dist], axis=-1).astype(np.float32)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_forward_matches_jax_reference_and_pallas(rng, r):
    pe = _random_plane_eq(rng)
    got = tlpg.local_planar_guidance(torch.from_numpy(pe), r).numpy()
    want = np.asarray(jlpg.lpg_reference(jnp.asarray(pe), r))
    pallas = np.asarray(lpg_pallas(jnp.asarray(pe), r, interpret=True))
    assert got.shape == want.shape == (2, 4 * r, 6 * r)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_decode_and_normalize_match_jax(rng, r):
    raw = rng.normal(scale=2.0, size=(2, 3, 5, 3)).astype(np.float32)
    got = tlpg.decode_plane_eq(torch.from_numpy(raw), 10.0)
    want = jlpg.decode_plane_eq(jnp.asarray(raw), 10.0)
    # atol: one f32 ulp of phi near 2*pi (4.8e-7). sin/cos of the same phi
    # differ by about that between XLA's and torch's implementations, which
    # no rtol absorbs where cos(phi) or sin(phi) is near 0.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=5e-7)
    plane = rng.normal(size=(2, 3, 5, 4)).astype(np.float32) * r
    np.testing.assert_allclose(
        tlpg.normalize_plane(torch.from_numpy(plane)).numpy(),
        np.asarray(jlpg.normalize_plane(jnp.asarray(plane))),
        rtol=1e-6,
    )


@pytest.mark.parametrize("r", [2, 4, 8])
def test_backward_matches_jax_vjp(rng, r):
    pe = _random_plane_eq(rng, b=1, h=2, w=3)
    g = rng.normal(size=(1, 2 * r, 3 * r)).astype(np.float32)
    pt = torch.from_numpy(pe).requires_grad_(True)
    tlpg.local_planar_guidance(pt, r).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda p: jlpg.local_planar_guidance(p, r), jnp.asarray(pe))
    np.testing.assert_allclose(
        pt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("r", [2, 4, 8])
def test_gradcheck_float64(rng, r):
    pe = torch.from_numpy(_random_plane_eq(rng, b=1, h=2, w=2).astype(np.float64))
    pe.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda p: tlpg.local_planar_guidance(p, r), (pe,), eps=1e-6, atol=1e-5
    )


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_cpu_tensor_takes_plain_version(rng, impl):
    pe = torch.from_numpy(_random_plane_eq(rng))
    before = lpg_cuda.LAUNCHES
    got = tlpg.local_planar_guidance(pe, 4, impl=impl)
    assert lpg_cuda.LAUNCHES == before
    torch.testing.assert_close(got, tlpg.lpg_reference(pe, 4), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_fused_site_equals_old_composition(rng, r, dtype):
    """The decoder's site in one pass gives the bits of the old
    (lpg(plane_eq, r) / max_depth).to(dtype)."""
    pe = torch.from_numpy(_random_plane_eq(rng))
    want = (tlpg.lpg_reference(pe, r) / 10.0).to(dtype)
    for got in (tlpg.local_planar_guidance(pe, r, max_depth=10.0, out_dtype=dtype),
                tlpg.lpg_scaled_reference(pe, r, 10.0, dtype)):
        assert got.dtype == dtype and tuple(got.shape) == (2, 4 * r, 6 * r)
        assert torch.equal(got, want)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_fused_site_gradient_float64(rng, r):
    """Its backward equals autograd's through the old composition (the bare
    LPG, the division, the cast), and passes gradcheck."""
    pe = torch.from_numpy(_random_plane_eq(rng, b=1, h=2, w=3).astype(np.float64))
    g = torch.from_numpy(rng.normal(size=(1, 2 * r, 3 * r)))
    got_pe, old_pe, plain_pe = (pe.clone().requires_grad_(True) for _ in range(3))
    tlpg.local_planar_guidance(got_pe, r, max_depth=10.0, out_dtype=torch.float64).backward(g)
    (tlpg.local_planar_guidance(old_pe, r) / 10.0).to(torch.float64).backward(g)
    (tlpg.lpg_reference(plain_pe, r) / 10.0).backward(g)
    torch.testing.assert_close(got_pe.grad, old_pe.grad, rtol=0, atol=0)
    torch.testing.assert_close(got_pe.grad, plain_pe.grad, rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda p: tlpg.local_planar_guidance(p, r, max_depth=10.0), (pe.requires_grad_(True),),
        eps=1e-6, atol=1e-5)


def test_fused_site_gradient_through_bf16(rng):
    """With bf16 out, the gradient goes back through the cast to f32 and the
    division as autograd takes them: the old composition's bits."""
    pe = torch.from_numpy(_random_plane_eq(rng))
    g = torch.from_numpy(rng.normal(size=(2, 16, 24)).astype(np.float32)).to(torch.bfloat16)
    got_pe, old_pe = (pe.clone().requires_grad_(True) for _ in range(2))
    tlpg.local_planar_guidance(got_pe, 4, max_depth=10.0, out_dtype=torch.bfloat16).backward(g)
    (tlpg.local_planar_guidance(old_pe, 4) / 10.0).to(torch.bfloat16).backward(g)
    torch.testing.assert_close(got_pe.grad, old_pe.grad, rtol=0, atol=0)


def test_kernel_scale_is_pytorchs_f32_reciprocal():
    """The kernel multiplies by f32(1 / f32(max_depth)), as PyTorch's CUDA
    division by a Python float does; no scale is exactly 1."""
    for md in (10.0, 80.0, 3.0):
        assert lpg_cuda.inv_scale(md) == float(np.float32(1.0) / np.float32(md))
    assert lpg_cuda.inv_scale(None) == 1.0


def test_bad_impls_raise(rng):
    """An unknown impl raises; 'ffi' (the native CPU kernel) runs on a CPU
    tensor (tests/test_torch_lpg_cpu.py holds it to its plain version) and
    raises for a tensor on another device, without copying it to the host."""
    pe = torch.from_numpy(_random_plane_eq(rng))
    torch.testing.assert_close(tlpg.local_planar_guidance(pe, 2, impl="ffi"),
                               tlpg.lpg_reference(pe, 2), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="CPU tensors"):
        tlpg.local_planar_guidance(pe.to("meta"), 2, impl="ffi")
    with pytest.raises(ValueError):
        tlpg.local_planar_guidance(pe, 2, impl="triton")


def test_kernel_wrapper_refuses_cpu_tensor(rng):
    pe = torch.from_numpy(_random_plane_eq(rng))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lpg_cuda.lpg_cuda(pe, 2)
    assert lpg_cuda.LAUNCHES == 0


def test_backward_kernel_wrapper_refuses_cpu_tensor_and_cpu_backward_is_plain(rng):
    """The backward kernel's wrapper raises for a CPU tensor; a CPU tensor's
    backward takes lpg_backward_scaled, bit for bit, and launches nothing."""
    pe = torch.from_numpy(_random_plane_eq(rng))
    g = torch.from_numpy(rng.normal(size=(2, 16, 24)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lpg_cuda.lpg_backward_cuda(pe, g, 4, 10.0)
    p = pe.clone().requires_grad_(True)
    tlpg.local_planar_guidance(p, 4, max_depth=10.0).backward(g)
    assert torch.equal(p.grad, tlpg.lpg_backward_scaled(pe, g, 4, 10.0))
    assert lpg_cuda.BWD_LAUNCHES == 0


def _emulate_backward_kernel(pe, grad, r, rows, inv_scale):
    """csrc/lpg.cu's lpg_bwd_kernel in numpy f32: thread t of the 1-D grid
    takes tile rows [rows * (t % tpc), +rows) of cell t // tpc (tpc = r /
    rows), reads them through the gradient's element strides, keeps its four
    partial sums in the kernel's order, and the cell's tpc partials are added
    by the butterfly (xor m = tpc/2 .. 1); lane 0's sums are the result."""
    f32 = np.float32
    b, h, w, _ = pe.shape
    tpc = r // rows
    sb, sy, sx = (st // grad.itemsize for st in grad.strides)
    extent = 1 + sum((d - 1) * st for d, st in zip(grad.shape, (sb, sy, sx)))
    flat = np.lib.stride_tricks.as_strided(grad, (extent,), (grad.itemsize,))  # its memory
    cells = b * h * w
    t = np.arange(cells * tpc)
    cell, j0 = t // tpc, (t % tpc) * rows
    cx, row = cell % w, cell // w
    cy, bb = row % h, row // h
    n = pe.reshape(-1, 4)[cell]
    offset = lambda i: (f32(i) - f32((r - 1) * 0.5)) * f32(1.0 / r)  # noqa: E731
    base = bb * sb + (cy * r + j0) * sy + cx * r * sx
    s = np.zeros((4, t.size), f32)
    for jj in range(rows):
        v = offset(j0 + jj).astype(f32)
        bj = n[:, 1] * v
        for i in range(r):
            u = offset(i)
            gi = flat[base + jj * sy + i * sx].astype(f32) * f32(inv_scale)
            den = (n[:, 0] * u + bj) + n[:, 2]
            inv = f32(1) / den
            c = ((gi * n[:, 3]) * inv) * inv
            s += np.stack([c * u, c * v, c, gi * inv])
    s = s.reshape(4, cells, tpc)
    m = tpc // 2
    while m:
        s = s + s[:, :, np.arange(tpc) ^ m]
        m //= 2
    return np.stack([-s[0, :, 0], -s[1, :, 0], -s[2, :, 0], s[3, :, 0]], -1).reshape(b, h, w, 4)


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_backward_kernel_mapping_emulated(rng, r, rows):
    """The backward kernel's thread mapping and summation order, emulated on
    a strided gradient (a channel of a wider map, ragged 3x5x7 cells),
    against lpg_backward_scaled: each component within rtol 1e-5 of the sum
    of its terms' magnitudes plus atol 1e-6 (chip_smoke.py's LPG_BWD_TOL:
    only the order of the f32 sums differs). The sub-pixel offset's product
    with 1/r has the division's bits for every r and i."""
    for i in range(r):
        assert np.float32(i - (r - 1) * 0.5) * np.float32(1 / r) == np.float32(
            np.float32(i - (r - 1) * 0.5) / np.float32(r))
    pe = _random_plane_eq(rng, 3, 5, 7)
    wide = rng.normal(size=(3, 4, 5 * r, 7 * r)).astype(np.float32)
    grad = wide[:, 2]
    inv = lpg_cuda.inv_scale(10.0)
    got = _emulate_backward_kernel(pe, grad, r, rows, inv)
    want = tlpg.lpg_backward_scaled(torch.from_numpy(pe), torch.from_numpy(grad.copy()), r,
                                    10.0).numpy()
    pe64, g64 = pe.astype(np.float64), grad.astype(np.float64).reshape(3, 5, r, 7, r) * inv
    u = (np.arange(r) - (r - 1) / 2) / r
    den = (pe64[..., 0][:, :, None, :, None] * u + pe64[..., 1][:, :, None, :, None]
           * u[:, None, None] + pe64[..., 2][:, :, None, :, None])
    c = np.abs(g64 * pe64[..., 3][:, :, None, :, None] / den**2)
    scale = np.stack([(c * np.abs(u)).sum((2, 4)), (c * np.abs(u)[:, None, None]).sum((2, 4)),
                      c.sum((2, 4)), np.abs(g64 / den).sum((2, 4))], -1)
    assert np.all(np.abs(got - want) <= 1e-6 + 1e-5 * scale)


def test_import_builds_nothing():
    """Importing the kernel modules compiles and loads nothing."""
    code = (
        "import json, sys\n"
        "import bts_tpu_torch.ops.lpg_cuda as c, bts_tpu_torch.ops._build as b\n"
        "print(json.dumps({'lib': b._LIB is None, 'launches': c.LAUNCHES,\n"
        "  'cpp_ext': 'torch.utils.cpp_extension' in sys.modules,\n"
        "  'triton': 'triton' in sys.modules}))\n"
    )
    build_dir = os.path.join(ROOT, "build", "kernels")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        check=True,
    )
    after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "lib": True, "launches": 0, "cpp_ext": False, "triton": False,
    }
    assert before == after


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()
    name = _build.library_path().name
    assert name.startswith("libbts_kernels_") and name.endswith(".so")
    assert _build.library_path() == _build.library_path()  # content-addressed
