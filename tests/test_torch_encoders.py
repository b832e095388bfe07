"""bts_tpu_torch's ResNet, ResNeXt and MobileNetV2 encoders against bts_tpu's
with the same weights, on the CPU in f32; their full-size parameter trees
against bts_tpu's through the weight bridge; and the seeded init of a
grouped conv against flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models import bts as jbts
from bts_tpu.models.encoders import mobilenet as jmobilenet
from bts_tpu.models.layers import Conv as JaxConv
from bts_tpu_torch.models import bts
from bts_tpu_torch.models.convert import state_dict_from_flax, torch_key
from bts_tpu_torch.models.encoders import mobilenet

from torch_threads import one_thread  # noqa: F401 (fixture)
from torch_zoo_helpers import H, TINY_RESNETS, W, jax_tiny_resnet, seeded_variables
from torch_zoo_helpers import torch_tiny_resnet

ENCODER_CASES = {
    **{name.removesuffix("_bts"): (jax_tiny_resnet(*gw), torch_tiny_resnet(*gw))
       for name, gw in TINY_RESNETS.items()},
    "mobilenetv2": (jmobilenet.mobilenetv2, mobilenet.mobilenetv2),
}
NEW_ENCODERS = ["resnet50_bts", "resnet101_bts", "resnext50_bts", "resnext101_bts",
                "mobilenetv2_bts"]


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_skips_match_bts_tpu(case):
    """All five skips at rtol 1e-4, atol 1e-5 (cuDNN-free CPU convs on both
    sides; only the summation order differs). ResNet and ResNeXt 32x4d and
    32x8d at one block a layer, MobileNetV2 whole."""
    jfactory, tfactory = ENCODER_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    jenc = jfactory()
    params, stats = seeded_variables(
        lambda: jenc.init(jax.random.key(0), jnp.asarray(x), train=False), rng)
    want = jax.jit(lambda v, im: jenc.apply(v, im, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))

    enc = tfactory().eval()
    state = state_dict_from_flax({"encoder": params}, {"encoder": stats})
    enc.load_state_dict({k.removeprefix("encoder."): v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))

    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("encoder", NEW_ENCODERS)
def test_full_size_tree_and_skips(encoder):
    """At full width and depth: the port's encoder state dict has exactly
    bts_tpu's leaves under their torch names, in torch's layouts; the skips
    have the registry's channels at H/2 ... H/32."""
    jfactory, jchannels = jbts.ENCODERS[encoder]
    factory, channels = bts.ENCODERS[encoder]
    assert channels == jchannels
    jenc = jfactory()
    shapes = jax.eval_shape(
        lambda: jenc.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False))
    want = {}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            keys = ("encoder",) + tuple(str(getattr(k, "key", k)) for k in path)
            shape = leaf.shape
            if keys[-1] == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])
            want[torch_key(keys, leaf.shape).removeprefix("encoder.")] = shape

    enc = factory().eval()
    got = {k: tuple(v.shape) for k, v in enc.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    with torch.no_grad():
        skips = enc(torch.zeros(1, 3, H, W))
    assert [tuple(s.shape) for s in skips] == [
        (1, c, H // d, W // d) for d, c in zip([2, 4, 8, 16, 32], channels)
    ]


def test_grouped_conv_init_matches_flax():
    """init_weights draws a ResNeXt grouped conv (32 groups of 4 of 128
    channels) from flax's Xavier-uniform range: fans of the grouped kernel
    (3, 3, 4, 128), bound sqrt(6 / (9 * (4 + 128)))."""
    jconv = JaxConv(128, (3, 3), padding=1, groups=32)
    kernel = np.asarray(jconv.init(jax.random.key(0), jnp.zeros((1, 8, 8, 128)))
                        ["params"]["conv"]["kernel"])
    assert kernel.shape == (3, 3, 4, 128)
    conv = torch.nn.Conv2d(128, 128, 3, padding=1, groups=32, bias=False)
    bts.init_weights(conv, torch.Generator().manual_seed(0))
    weight = conv.weight.detach().numpy()
    assert weight.shape == (128, 4, 3, 3)
    bound = np.sqrt(6.0 / (9 * (4 + 128)))
    for w in (kernel, weight):
        assert bound * 0.99 < np.abs(w).max() <= bound
        # A uniform draw on [-b, b] has standard deviation b / sqrt(3); 4608
        # draws put the estimate within about 1% of it.
        np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.05)
