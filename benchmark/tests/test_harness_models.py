"""A model that is not BTS goes through the harness as files of its own: a
toy with a conv stem, a LayerNorm, a windowed attention with a relative
position bias, and a conv head (``toy_model.py``), found through
``spec.model``. A whole CPU run of it is correct, and not with a stale
answer; its seeded weights follow the rules of ``weights.py``; its forward
FLOPs are counted by hand; the float8 control reaches its linear layer.

Pins of BTS, as the harness computed them before models had files of their
own: the seeded state dict's digest at the tiny size and the forward FLOPs
at batch 8 and the published size.
"""

from __future__ import annotations

import hashlib
import math
import time

import pytest
import torch

from benchmark import flops, run, spec, weights
from benchmark.reference.lowp import fp8_round, set_quant
from benchmark.tests import toy_model
from benchmark.tests.tiny import tiny_config, tiny_traffic

CPU = torch.device("cpu")
TOY = toy_model.CONFIG
SEED = 2**31 + 4099
PINS = {  # sha256 of the tiny state dict at seed 5; forward FLOPs at batch 8
    "bts-nyu-densenet161": (
        "f82f25725d57b1bbc101b65d180d822a2ddf45e4abc79f6b2d56a599871e1cfd", 1_943_656_243_200),
    "bts-kitti-resnext101": (
        "3bc4b65265554a46f85c96ccc73c31c779551dbf85591f859b93617cae8ac315", 4_114_215_333_888),
}


@pytest.fixture
def toy(monkeypatch):
    real = spec.model
    monkeypatch.setattr(spec, "model",
                        lambda config: toy_model if config.get("model") == "toy" else real(config))


def stale(forward):
    last = []

    def broken(model, image, focal):  # the previous call's answers
        last.append(forward(model, image, focal))
        return last[-2] if len(last) > 1 else last[-1]

    return broken


@pytest.mark.parametrize("fault", [None, "stale"])
def test_toy_run(toy, monkeypatch, fault):
    traffic = spec.traffic
    monkeypatch.setattr(spec, "config", lambda name: dict(TOY))
    monkeypatch.setattr(spec, "traffic", lambda name: tiny_traffic(traffic(name)))
    if fault:
        from bts_tpu_torch.apps import predict

        monkeypatch.setattr(predict, "forward_padded", stale(predict.forward_padded))
    result = run.execute("nyu-d161-serve-b8", SEED, 0.5, False, CPU, t0=time.perf_counter())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] == (fault is None), result["checks"]


def test_toy_seeded_weights(toy):
    a, b = weights.seeded_state_dict(TOY, 5, CPU), weights.seeded_state_dict(TOY, 5, CPU)
    other = weights.seeded_state_dict(TOY, 6, CPU)
    built = toy_model.Toy(TOY).state_dict()
    computed = ["position", "attn.relative_position_index"]
    assert list(a) == [k for k in built if k not in computed]
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    qkv, table = "attn.qkv.weight", "attn.relative_position_bias_table"
    bound = math.sqrt(6.0 / (32 + 96))
    assert 0.9 * bound < a[qkv].abs().max() <= bound
    assert not torch.equal(a[qkv], other[qkv]) and not torch.equal(a[table], other[table])
    # The first stream: the stem's weights are the first draw of the seed's rand.
    stem = a["stem.weight"]
    stem_bound = math.sqrt(6.0 / ((3 + 32) * 16))
    first = torch.rand(stem.numel(), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(stem.flatten(), first * (2 * stem_bound) - stem_bound,
                               rtol=0, atol=0)
    assert torch.equal(a["norm.weight"], torch.ones(32))
    for k in ("norm.bias", "attn.qkv.bias", "stem.bias", "head.bias"):
        assert torch.equal(a[k], torch.zeros_like(a[k])), k
    assert abs(a[table].std().item() - 0.02) < 0.002 and abs(a[table].mean().item()) < 0.002
    # The computed buffers, a floating one too, are the reference's own code's.
    model = weights.reference_model(TOY, 5, CPU)
    index, position = model.attn.relative_position_index, model.position
    assert index.dtype == torch.long and position.dtype == torch.float32
    assert torch.equal(index, built["attn.relative_position_index"])
    assert torch.equal(position, built["position"])
    assert index[0, 0] == 7 * 15 + 7 and index.max() == 15 * 15 - 1
    assert torch.equal(position[0], (torch.arange(32) % 2).float())  # sin 0, cos 0
    for k in a:
        assert torch.equal(model.state_dict()[k], a[k]), k


def test_toy_forward_flops(toy):
    b, h, w, c, p, s, heads = 2, 64, 96, 32, 4, 8, 4
    tokens = b * (h // p) * (w // p)
    windows = tokens // (s * s)
    stem = 2 * tokens * c * 3 * p * p
    qkv = 2 * tokens * c * 3 * c
    attention = 2 * (2 * windows * heads * (s * s) ** 2 * (c // heads))  # QK^T and AV
    head = 2 * tokens * c * 9
    assert flops.forward_flops(TOY, b, h, w) == stem + qkv + attention + head


def test_toy_control_reaches_linear(toy):
    model = weights.reference_model(TOY, 7, CPU).eval()
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    focal = torch.full((2,), TOY["focal"])
    with torch.no_grad():
        exact = model(x, focal)
        set_quant(model, fp8_round)
        assert model.attn.qkv.quant is fp8_round and model.stem.quant is fp8_round
        rounded = model(x, focal)
    assert (rounded - exact).abs().max() > 1e-3


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", PINS)
def test_bts_config_keys_pinned(name):
    """What BTS is built from, and the published training recipe that the
    train cells will run, stay in both configurations."""
    config = spec.config(name)
    for key in ("encoder", "encoder_arch", "bts_size", "dataset", "max_depth", "train"):
        assert key in config and key in spec.model(config).KEYS, key


@pytest.mark.parametrize("name", PINS)
def test_bts_seeded_weights_pinned(name):
    config = tiny_config(spec.config(name))
    assert digest(weights.seeded_state_dict(config, 5, CPU)) == PINS[name][0]


@pytest.mark.parametrize("name", PINS)
def test_bts_forward_flops_pinned(name):
    c = spec.config(name)
    assert flops.forward_flops(c, 8, c["input_height"], c["input_width"]) == PINS[name][1]
