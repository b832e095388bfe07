"""The frozen reference against the program, float32 on the CPU, same
weights: the forward of both encoder families."""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, program, spec
from benchmark.tests.tiny import tiny_config
from benchmark.weights import reference_model, seeded_state_dict

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["bts-nyu-densenet161", "bts-kitti-resnext101"])
def test_forward_matches_program(name):
    config = tiny_config(spec.config(name))
    port = program.port_model(config, seeded_state_dict(config, 3, CPU), CPU).eval()
    ref = reference_model(config, 3, CPU).eval()
    x = torch.randn(2, 3, config["input_height"], config["input_width"],
                    generator=torch.Generator().manual_seed(0))
    focal = torch.tensor([config["focal"], 0.9 * config["focal"]])
    with torch.no_grad():
        want = ref(x, focal)
        got = port(x, focal)[4]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_seeded_weights():
    config = tiny_config(spec.config("bts-nyu-densenet161"))
    a, b = seeded_state_dict(config, 5, CPU), seeded_state_dict(config, 5, CPU)
    c = seeded_state_dict(config, 2**31 + 12345, CPU)
    for k in a:
        assert torch.equal(a[k], b[k])
    conv = "encoder.base_model.conv0.weight"
    assert not torch.equal(a[conv], c[conv])
    o, i, kh, kw = a[conv].shape
    assert a[conv].abs().max() <= (6.0 / ((i + o) * kh * kw)) ** 0.5
    assert torch.equal(a["decoder.bn5.running_var"], torch.ones(config["bts_size"]))


def test_depth_gaps():
    ref = torch.full((2, 4, 4), 2.0).numpy()
    port = ref.copy()
    port[0, 0, 0] = 3.0
    gaps = compare.depth_gaps(port, ref)
    assert gaps["depth_max_m"] == 1.0 and gaps["depth_absrel"] == pytest.approx(0.5 / 32)


def test_reservoir_keeps_a_seeded_uniform_sample():
    def sample(seed, n):
        r = compare.Reservoir(3, seed)
        for i in range(n):
            r.offer(lambda: i)
        return sorted(r.items)

    assert sample(1, 2) == [0, 1] and sample(5, 100) == sample(5, 100)
    counts = [0] * 10
    for seed in range(2000):
        for i in sample(seed, 10):
            counts[i] += 1
    assert all(abs(c - 600) < 90 for c in counts)  # 3 of 10 kept, each ~600 times in 2000
