"""``ops/layer_norm`` and ``layers.LayerNorm`` on the CPU: the plain version
against a float64 LayerNorm for float32 and bfloat16 inputs and outputs;
the kernel's program shapes at every width of ``large07``; the dtype that
each norm of the tiny NeWCRFs (``test_torch_newcrfs.TINY``) writes under
autocast and without it; the launch counter's registration; and the
affine, which the benchmark's seeded weights leave at identity, moving the
depth."""

import pytest
import torch
import torch.nn.functional as F

from bts_tpu_torch import ops
from bts_tpu_torch.models import layers, newcrfs
from bts_tpu_torch.models.encoders import swin
from bts_tpu_torch.ops import layer_norm as ln
from test_torch_newcrfs import TINY

from torch_threads import one_thread  # noqa: F401 (fixture)

EPS = 1e-5
H, W = 64, 96
# Every LayerNorm width of large07 (Swin 192-1536, patch merging 768-3072,
# the CRF levels 128-1024).
WIDTHS = (128, 192, 256, 384, 512, 768, 1024, 1536, 3072)
# The norms that write the autocast dtype: each one's one reader is a Linear
# (qkv, qk, fc1, reduction) or a convolution (proj_x, proj_v, disp_head1).
TO_GEMM = ("norm1", "norm2", "downsample.norm", "backbone.norm0", "backbone.norm1",
           "backbone.norm2", "norm_crf")


def affine(c, gen):
    return 1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen)


@pytest.mark.parametrize("c", [192, 128])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_is_a_float32_layer_norm(c, in_dtype, out_dtype):
    """Against the norm in float64 of the same input: float32 within its
    rounding; a bfloat16 output within one bf16 ulp (2^-8 to 2^-7 of the
    value) of the float64 result rounded, where the float32 one lies on the
    other side of a rounding boundary."""
    gen = torch.Generator().manual_seed(c)
    x = (3 + 2 * torch.randn(2, 5, c, generator=gen)).to(in_dtype)
    w, b = affine(c, gen)
    got = ln.layer_norm_plain(x, w, b, EPS, out_dtype)
    x64 = x.double()
    mean, var = x64.mean(-1, keepdim=True), x64.var(-1, unbiased=False, keepdim=True)
    want = (x64 - mean) / torch.sqrt(var + EPS) * w.double() + b.double()
    assert got.dtype == out_dtype and got.shape == x.shape
    if out_dtype == torch.float32:
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.to(out_dtype).float(), rtol=2 ** -7,
                                   atol=0)


def test_cpu_takes_the_plain_version():
    """On the CPU ``layer_norm`` is the plain version, and in float32 it is
    ``F.layer_norm`` bit for bit: the float32 CPU forward is unchanged."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 7, 192, generator=gen)
    w, b = affine(192, gen)
    got = ln.layer_norm(x, w, b, EPS, torch.float32)
    assert torch.equal(got, F.layer_norm(x, (192,), w, b, EPS))
    xb = x.bfloat16()
    assert torch.equal(ln.layer_norm(xb, w, b, EPS, torch.bfloat16),
                       ln.layer_norm_plain(xb, w, b, EPS, torch.bfloat16))


@pytest.mark.parametrize("fault", ["float16 in", "float16 out", "weight width", "bf16 weight",
                                   "kernel on the CPU"])
def test_refused(fault):
    x, w, b, out = torch.randn(4, 8), torch.ones(8), torch.zeros(8), torch.float32
    call, error = ln.layer_norm, ValueError
    if fault == "float16 in":
        x, error = x.half(), TypeError
    elif fault == "float16 out":
        out, error = torch.float16, TypeError
    elif fault == "weight width":
        w = torch.ones(9)
    elif fault == "bf16 weight":
        w = w.bfloat16()
    else:
        call = ln.layer_norm_triton
    with pytest.raises(error):
        call(x, w, b, EPS, out)


@pytest.mark.parametrize("c", WIDTHS)
def test_program_shapes(c):
    """At every width and dtype pair: C padded to the power of two at or
    above it, at least about 16 KB read and written a program, at most
    8192 elements held (32 registers a thread of 8 warps), 4-16 warps."""
    for in_bytes in (2, 4):
        for out_bytes in (2, 4):
            block_c, rows, warps = ln.program_shape(c, in_bytes, out_bytes)
            assert block_c >= c > block_c // 2 and block_c & (block_c - 1) == 0
            assert rows & (rows - 1) == 0 and rows * block_c <= 8192
            assert rows * c * (in_bytes + out_bytes) >= ln.PROGRAM_BYTES
            assert 4 <= warps <= 16


def test_norm_writes_the_gemm_dtype_under_autocast():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 64, generator=gen)
    gemm, stream = layers.LayerNorm(64, to_gemm=True), layers.LayerNorm(64, to_gemm=False)
    assert list(gemm.state_dict()) == ["weight", "bias"] and gemm.eps == EPS
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert gemm(x).dtype == torch.bfloat16 and stream(x).dtype == torch.float32
            assert gemm(x.bfloat16()).dtype == torch.bfloat16
            assert stream(x.bfloat16()).dtype == torch.float32
            # What autocast computed around nn.LayerNorm before, rounded
            # where the Linear that reads it rounds it.
            assert torch.equal(gemm(x.bfloat16()),
                               F.layer_norm(x.bfloat16().float(), (64,)).bfloat16())
        assert gemm(x).dtype == stream(x).dtype == torch.float32
        assert torch.equal(gemm(x), F.layer_norm(x, (64,)))


def norm_dtypes(model, image, **autocast):
    """(each LayerNorm's output dtype, each Swin block's output dtype) by
    module name, over one forward."""
    norms, blocks = {}, {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, layers.LayerNorm):
            hooks.append(m.register_forward_hook(
                lambda m, i, o, n=name: norms.__setitem__(n, o.dtype)))
        elif isinstance(m, swin.SwinTransformerBlock):
            hooks.append(m.register_forward_hook(
                lambda m, i, o, n=name: blocks.__setitem__(n, o.dtype)))
    with torch.no_grad(), torch.autocast("cpu", **autocast):
        depth = model(image, torch.full((image.shape[0],), 518.8579))[-1]
    for h in hooks:
        h.remove()
    assert depth.dtype == torch.float32 and torch.isfinite(depth).all()
    return norms, blocks


@pytest.fixture(scope="module")
def tiny():
    model = newcrfs.NeWCRFsModel(10.0, **TINY).eval()
    return newcrfs.init_weights(model, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def image():
    return torch.randn(1, 3, H, W, generator=torch.Generator().manual_seed(0))


def test_site_rule_on_tiny_newcrfs(tiny, image):
    """Under bf16 autocast the norms read by a Linear or a convolution write
    bf16; ``patch_embed.norm`` (stage 1's residual stream) and ``norm3``
    (pooled by the PSP) write float32, and stage 1's blocks keep the stream
    in float32 while stages 2-4 carry bf16. Without autocast every norm
    writes float32."""
    norms, blocks = norm_dtypes(tiny, image, dtype=torch.bfloat16)
    # Swin's 8 blocks, 3 merges, norm0-norm3, 4 CRF levels, the patch embedding.
    assert len(norms) == 8 * 2 + 3 + 4 + 4 * 5 + 1
    for name, dtype in norms.items():
        want = torch.bfloat16 if name.endswith(TO_GEMM) else torch.float32
        assert dtype == want, name
    assert norms["backbone.patch_embed.norm"] == norms["backbone.norm3"] == torch.float32
    for name, dtype in blocks.items():
        assert dtype == (torch.float32 if name.startswith("backbone.layers.0.")
                         else torch.bfloat16), name
    norms, blocks = norm_dtypes(tiny, image, enabled=False)
    assert set(norms.values()) == set(blocks.values()) == {torch.float32}


def test_kernel_launches_are_counted_by_replays():
    assert ops.LAUNCH_COUNTERS[f"{ln.__name__}.LAUNCHES"] == (ln, "LAUNCHES")


@pytest.mark.parametrize("mutation", ["weight ignored", "bias ignored"])
def test_affine_moves_the_depth(tiny, image, monkeypatch, mutation):
    """With the norms drawn off identity, a plain version that drops the
    weight or the bias moves the depth by more than ten times the tolerance
    that ``test_torch_newcrfs`` holds the port to (1e-4)."""
    model = newcrfs.NeWCRFsModel(10.0, **TINY).eval()
    model.load_state_dict(tiny.state_dict())
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.LayerNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    focal = torch.full((1,), 518.8579)
    with torch.no_grad():
        want = model(image, focal)[-1]
    real = ln.layer_norm_plain

    def mutated(x, weight, bias, eps, out_dtype):
        if mutation == "weight ignored":
            weight = torch.ones_like(weight)
        else:
            bias = torch.zeros_like(bias)
        return real(x, weight, bias, eps, out_dtype)

    monkeypatch.setattr(ln, "layer_norm_plain", mutated)
    with torch.no_grad():
        got = model(image, focal)[-1]
    assert (got - want).abs().max() > 1e-3
