"""``ops/global_attention`` on the CPU: the plain version against a float64
softmax at token counts around the kernel's tiles (1, 63, 64, 65, 127, 128,
129), read from a ``qkv`` output as a ViT block hands it; bf16 inputs; the
wrapper's refusals; the launch counter in ``ops.LAUNCH_COUNTERS``."""

import pytest
import torch

from bts_tpu_torch import ops
from bts_tpu_torch.ops import global_attention as ga

from torch_threads import one_thread  # noqa: F401 (fixture)

HEADS, D = 2, ga.HEAD_DIM


def qkv_views(n, b=2, dtype=torch.float32, seed=0):
    """q, k, v (b, n, heads, d) as views of one (b, n, 3, heads, d) output."""
    qkv = torch.randn(b, n, 3, HEADS, D, generator=torch.Generator().manual_seed(seed))
    qkv = qkv.to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def softmax64(q, k, v, scale):
    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) * scale
    o = torch.einsum("bhnm,bmhd->bnhd", s.softmax(-1), v.double())
    return o.reshape(q.shape[0], q.shape[1], -1)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129])
def test_plain_matches_float64_softmax(n):
    q, k, v = qkv_views(n, seed=n)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    got = ga.global_attention(q, k, v, D ** -0.5)
    want = softmax64(q, k, v, D ** -0.5)
    assert got.shape == (2, n, HEADS * D) and got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    low = ga.global_attention(*(t.bfloat16() for t in (q, k, v)), D ** -0.5)
    assert low.dtype == torch.bfloat16
    torch.testing.assert_close(low.double(), want, rtol=0.05, atol=0.05)


def test_plain_rounds_p_to_the_inputs_dtype():
    """bf16 inputs: P is rounded to bf16 before P V, as the kernel rounds it."""
    q, k, v = (t.bfloat16() for t in qkv_views(65, seed=1))
    got = ga.global_attention_plain(q, k, v, 0.125)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * 0.125
    p = s.softmax(-1).bfloat16().float()
    want = torch.einsum("bhnm,bmhd->bnhd", p, v.float()).reshape(2, 65, -1).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_refusals():
    q, k, v = qkv_views(8)
    with pytest.raises(ValueError, match="CUDA"):
        ga.global_attention_triton(q, k, v, 0.125)
    with pytest.raises(ValueError, match=r"\(B, N, heads, d\)"):
        ga.global_attention(q[0], k[0], v[0], 0.125)
    with pytest.raises(ValueError, match="v is"):
        ga.global_attention(q, k, v[:, :4], 0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ga.global_attention(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="head dimension"):
        ga.global_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="contiguous in their last dimension"):
        ga.global_attention(torch.randn(2, 8, HEADS, 2 * D)[..., ::2], k, v, 0.125)


def test_kernel_launches_are_counted_by_replays():
    assert ops.LAUNCH_COUNTERS[f"{ga.__name__}.LAUNCHES"] == (ga, "LAUNCHES")
    assert ga.HEAD_DIM == 64 and set(ga.CONFIGS) == set(ga.DTYPES)
