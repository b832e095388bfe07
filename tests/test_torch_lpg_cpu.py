"""The native CPU LPG (``csrc/lpg_cpu.cc``, ``--lpg_impl ffi``) on the CPU in
f32: forward and gradient against bts_tpu's native kernel (``lpg_ffi``, when
its build is available, as tests/test_lpg_ffi.py checks) and against the
port's plain versions, at tests/test_lpg_ffi.py's tolerances (forward rtol
1e-5, atol 1e-6; gradient rtol 1e-4, atol 1e-5), at r = 2, 4, 8 and ragged
ratios; the wrappers' refusals; the g++ build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu_torch.ops import _build, lpg, lpg_cpu

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _planes(rng, b=2, h=3, w=5):
    theta = rng.uniform(0.05, np.pi / 3, size=(b, h, w))
    phi = rng.uniform(0, 2 * np.pi, size=(b, h, w))
    dist = rng.uniform(0.5, 10.0, size=(b, h, w))
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta),
                     dist], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ffi():
    """bts_tpu's native LPG, or a skip where its toolchain is missing (as
    tests/test_lpg_ffi.py decides)."""
    from bts_tpu.ops import lpg_ffi

    try:
        lpg_ffi.build_library()
    except Exception as e:  # toolchain missing: skip, as test_lpg_ffi.py does
        pytest.skip(f"bts_tpu's native build unavailable: {e}")
    return lpg_ffi


@pytest.mark.parametrize("r", [2, 4, 8, 3, 5])
def test_forward_matches_bts_tpu_and_plain(jax_ffi, r):
    pe = _planes(np.random.default_rng(r))
    got = lpg_cpu.lpg_cpu(torch.from_numpy(pe), r).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ffi.lpg_ffi(jnp.asarray(pe), r)), **FWD_TOL)
    np.testing.assert_allclose(got, lpg.lpg_reference(torch.from_numpy(pe), r).numpy(),
                               **FWD_TOL)


@pytest.mark.parametrize("r", [2, 4, 8, 3])
def test_gradient_matches_bts_tpu_and_plain(jax_ffi, r):
    """The native VJP (n4 factor included) against bts_tpu's lpg_ffi VJP and
    the port's plain lpg_backward."""
    rng = np.random.default_rng(10 + r)
    pe = _planes(rng, b=1, h=2, w=3)
    g = rng.normal(size=(1, 2 * r, 3 * r)).astype(np.float32)
    got = lpg_cpu.lpg_backward_cpu(torch.from_numpy(pe), torch.from_numpy(g), r).numpy()
    _, vjp = jax.vjp(lambda p: jax_ffi.lpg_ffi(p, r), jnp.asarray(pe))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), **GRAD_TOL)
    np.testing.assert_allclose(
        got, lpg.lpg_backward(torch.from_numpy(pe), torch.from_numpy(g), r).numpy(), **GRAD_TOL)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_decoder_site_through_ffi(out_dtype):
    """local_planar_guidance(impl='ffi') at a decoder site (/ max_depth and the
    cast in PyTorch after the native call) and its autograd backward against
    the plain site (impl='xla'), at the native tolerances; each direction is
    one native call."""
    rng = np.random.default_rng(20)
    pe = torch.from_numpy(_planes(rng, b=2, h=4, w=6))
    g = torch.from_numpy(rng.normal(size=(2, 16, 24)).astype(np.float32)).to(out_dtype)
    a, b = (pe.clone().requires_grad_(True) for _ in range(2))
    calls = (lpg_cpu.CALLS, lpg_cpu.BWD_CALLS)
    out = lpg.local_planar_guidance(a, 4, impl="ffi", max_depth=10.0, out_dtype=out_dtype)
    ref = lpg.local_planar_guidance(b, 4, impl="xla", max_depth=10.0, out_dtype=out_dtype)
    assert out.dtype == out_dtype
    torch.testing.assert_close(out.float(), ref.float(),
                               **(FWD_TOL if out_dtype == torch.float32 else
                                  dict(rtol=2**-8, atol=0)))
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL)
    assert (lpg_cpu.CALLS - calls[0], lpg_cpu.BWD_CALLS - calls[1]) == (1, 1)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """No copy to the host and no cast: a tensor on another device, a dtype
    other than f32 and a wrong shape each raise; so does impl='ffi' on a
    tensor off the CPU."""
    pe = torch.from_numpy(_planes(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="CPU tensor"):
        lpg_cpu.lpg_cpu(pe.to("meta"), 2)
    with pytest.raises(ValueError, match="CPU tensors"):
        lpg.local_planar_guidance(pe.to("meta"), 2, impl="ffi")
    with pytest.raises(TypeError, match="float32"):
        lpg_cpu.lpg_cpu(pe.double(), 2)
    with pytest.raises(ValueError, match=r"\(B,H,W,4\)"):
        lpg_cpu.lpg_cpu(pe[..., :3], 2)
    with pytest.raises(ValueError, match="grad shape"):
        lpg_cpu.lpg_backward_cpu(pe, torch.zeros(2, 5, 5), 2)
    with pytest.raises(TypeError, match="float32"):
        lpg_cpu.lpg_backward_cpu(pe, torch.zeros(2, 6, 10, dtype=torch.bfloat16), 2)


def test_cpu_library_builds_with_gxx_by_source_hash():
    """g++ (no nvcc) builds csrc/lpg_cpu.cc into the build directory, named by
    a hash of its source and flags; the CUDA sources stay *.cu only."""
    path = _build.build_cpu()
    assert path == _build.cpu_library_path() and path.is_file()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("liblpg_cpu_")
    assert _build.CPU_SOURCE.suffix == ".cc"
    assert all(p.suffix == ".cu" for p in _build._sources())
    lib = _build.load_cpu_library()
    assert lib is _build.load_cpu_library()
