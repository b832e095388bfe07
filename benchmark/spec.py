"""What a run measures, found by name: the cell's entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the generator in
``drivers/``), the limits of its correctness check (``limits/<cell>.json``)
and its per-layer metrics' readers (``metrics/<metric>.py``).

A new configuration, mix, cell or metric is a new file and a new entry in
``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics reported in ``cell_name``: those that list it,
    and those without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def driver(kind: str):
    """The generator module of a traffic kind, ``drivers/<kind>.py``."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
