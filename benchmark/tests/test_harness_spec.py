"""BENCHMARK.json and the files it names: every entry resolves to a file of
its own, and the entries keep to the shapes the format allows."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    config = spec.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    for key in ("encoder", "encoder_arch", "bts_size", "dataset", "max_depth", "focal",
                "input_height", "input_width", "compute_dtype", "train", "assumed"):
        assert key in config


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert hasattr(spec.driver(traffic["kind"]), "Driver")
    assert spec.limits(cell["name"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(BENCH, cell["name"])
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(spec.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
