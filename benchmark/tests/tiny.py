"""Tiny stand-ins for the benchmark's configurations and mixes, so a whole
run fits a CPU test: each configuration at its model file's ``tiny`` size,
two images a batch."""

from __future__ import annotations

import copy

from benchmark import spec


def tiny_config(config: dict) -> dict:
    return spec.model(config).tiny(config)


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
