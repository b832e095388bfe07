"""Tiny stand-ins for the benchmark's configurations and mixes, so a whole
run fits a CPU test: DenseNet121's published block at bts_size 128 and
64x96 frames, two images a batch."""

from __future__ import annotations

import copy

from benchmark import spec

DENSENET121 = {"family": "densenet", "block_config": [6, 12, 24, 16], "growth_rate": 32,
               "bn_size": 4, "num_init_features": 64}
RESNEXT50 = {"family": "resnet", "layers": [3, 4, 6, 3], "groups": 32, "width_per_group": 4}


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    if c["encoder_arch"]["family"] == "densenet":
        c.update(encoder="densenet121_bts", encoder_arch=dict(DENSENET121))
    else:
        c.update(encoder="resnext50_bts", encoder_arch=dict(RESNEXT50))
    c.update(bts_size=128, input_height=64, input_width=96)
    return c


def tiny_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    if "batch" in t:
        t["batch"] = 2
    return t


def shrink(monkeypatch) -> None:
    """Make ``spec`` hand out the tiny versions of every configuration and mix."""
    config, traffic = spec.config, spec.traffic
    monkeypatch.setattr(spec, "config", lambda name: tiny_config(config(name)))
    monkeypatch.setattr(spec, "traffic", lambda name: tiny_traffic(traffic(name)))
