"""bts_tpu_torch DenseNet encoders against bts_tpu's DenseNetEncoder (plain
concat path, split=False) with the same weights, on the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models.encoders import densenet as jdensenet
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.models.encoders import densenet

from test_torch_decoder import randomize_bn
from torch_threads import one_thread  # noqa: F401 (fixture)

TINY = ((2, 2, 2, 2), 8, 16)  # block_config, growth_rate, num_init_features


@pytest.mark.parametrize(
    "config,hw,dense_impl",
    [(TINY, (64, 96), "auto"), (((6, 12, 24, 16), 32, 64), (32, 32), "auto"),
     (TINY, (64, 128), "taps"), (TINY, (64, 128), "eo")],
    ids=["tiny", "densenet121", "tiny-taps", "tiny-eo"],
)
def test_skips_match_bts_tpu(config, hw, dense_impl):
    """auto on the CPU runs the unfused modules; taps and eo the plain
    versions of the fused layer (eo needs an even width at every block)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    jenc = jdensenet.DenseNetEncoder(*config, dtype=jnp.float32, split=False)
    variables = jenc.init(jax.random.key(0), jnp.asarray(x), train=False)
    params, stats = randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)

    enc = densenet.DenseNetEncoder(*config, dense_impl=dense_impl).eval()
    state = state_dict_from_flax({"encoder": params}, {"encoder": stats})
    enc.load_state_dict({k.removeprefix("encoder."): v for k, v in state.items()})
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))

    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize(
    "factory,channels",
    [(densenet.densenet121, [64, 64, 128, 256, 1024]),
     (densenet.densenet161, [96, 96, 192, 384, 2208])],
    ids=["densenet121", "densenet161"],
)
def test_skip_shapes(factory, channels):
    with torch.no_grad():
        skips = factory().eval()(torch.zeros(1, 3, 64, 96))
    assert [tuple(s.shape) for s in skips] == [
        (1, c, 64 // d, 96 // d) for d, c in zip([2, 4, 8, 16, 32], channels)
    ]
