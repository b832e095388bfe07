"""bts_tpu_torch BTSDecoder against bts_tpu's (plain tail, Pallas LPG in
interpret mode) with the same weights, on the CPU in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models.decoder import BTSDecoder as JaxDecoder
from bts_tpu_torch.models.convert import state_dict_from_flax
from bts_tpu_torch.models.decoder import BTSDecoder

H, W = 64, 96
FEAT = [64, 64, 128, 256, 1024]  # densenet121 widths


def randomize_bn(params, stats, rng):
    """BN scale/bias and running stats away from their init, so eval-mode BN
    and the name mapping of all four leaves are exercised."""

    def walk(p, s):
        for k in p:
            # "bn" also names MobileNetV2's BN shims, whose inner BN is "bn".
            if k == "bn" and "scale" in p[k]:
                c = p[k]["scale"].shape
                p[k] = {
                    "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(scale=0.1, size=c).astype(np.float32),
                }
                s[k] = {
                    "mean": rng.normal(scale=0.1, size=c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
                }
            elif isinstance(p[k], dict):
                walk(p[k], s.setdefault(k, {}))
                if not s[k]:
                    del s[k]

    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    walk(params, stats)
    return params, stats


@pytest.mark.parametrize("dataset,max_depth", [("nyu", 10.0), ("kitti", 80.0)])
def test_decoder_matches_bts_tpu(dataset, max_depth):
    rng = np.random.default_rng(0)
    skips = [
        rng.normal(size=(2, H // d, W // d, c)).astype(np.float32)
        for d, c in zip([2, 4, 8, 16, 32], FEAT)
    ]
    focal = np.array([518.8579, 721.5377], np.float32)

    jdec = JaxDecoder(
        max_depth=max_depth, dataset=dataset, num_features=512,
        lpg_impl="pallas", fast_tail=False,
    )
    jskips = [jnp.asarray(s) for s in skips]
    variables = jdec.init(jax.random.key(0), jskips, jnp.asarray(focal))
    params, stats = randomize_bn(variables["params"], variables["batch_stats"], rng)
    want = jdec.apply(
        {"params": params, "batch_stats": stats}, jskips, jnp.asarray(focal)
    )

    dec = BTSDecoder(FEAT, 512, max_depth, dataset, lpg_impl="pallas").eval()
    state = state_dict_from_flax({"decoder": params}, {"decoder": stats})
    dec.load_state_dict({k.removeprefix("decoder."): v for k, v in state.items()})
    with torch.no_grad():
        got = dec([torch.from_numpy(s).permute(0, 3, 1, 2) for s in skips],
                  torch.from_numpy(focal))

    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 1, H, W)
        # The tolerance of the decoder's parity test against the reference
        # (tests/test_decoder_parity.py): conv sums in another order.
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=5e-4, atol=5e-5
        )
