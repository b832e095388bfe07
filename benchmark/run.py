"""Run one cell of the benchmark of ``bts_tpu_torch`` on the card(s) of this
machine, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (seeded weights made on the card, the program's model loaded from
them, seeded inputs, warm-up of the cell's own shapes) runs from process
start to the window; the window measures for ``--seconds`` (with ``--trace
1``: for the mix's ``trace_seconds`` at most, under ``torch.profiler``);
then the program's state is freed and the plain reference checks what the
window produced. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number with
its limit (also the last lines of standard error).

Exits non-zero without a result when no CUDA card is visible, when the cell
asks for more cards than there are, or when ``jax``, ``jaxlib``, ``flax``
or ``bts_tpu`` is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache the program could write goes to a fixed directory of the
# checkout, so only a checkout's first run builds; the CUDA kernels go to
# build/kernels/ (bts_tpu_torch/ops/_build.py).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "build" / "cache" / _sub)
# The script's own directory would shadow modules such as ``trace``: the
# harness is imported as the package ``benchmark`` from the root instead.
sys.path[0] = str(ROOT)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bts_tpu")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``bts_tpu_torch`` is not ``bts_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def execute(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
            chips: int = 1, t0: float = _T0) -> dict:
    """One run of ``workload``: the result's fields, in the order printed."""
    from benchmark import compare, flops, spec
    from benchmark.trace import traced

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    counters = spec.model(config).counters
    limits = spec.limits(workload)
    cuda = device.type == "cuda"

    driver = spec.driver(traffic["kind"]).Driver(config, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    span = min(seconds, traffic["trace_seconds"]) if trace else seconds
    before = counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    with traced(trace) as tr:
        out = driver.window(span)
    peak = max(peak, torch.cuda.max_memory_allocated()) if cuda else 0
    after = counters()
    driver.release()
    try:
        numbers = driver.check()
    except (ValueError, FloatingPointError) as err:
        print(f"check failed: {err!r}", file=sys.stderr)
        numbers = {k: float("inf") for k in limits}
    checks = compare.held(numbers, limits)
    readings = {k: v for k, v in numbers.items() if k not in limits}

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": compare.all_held(checks) and out["failed"] == 0
              and out["attempted"] > 0,
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        timeline = tr.timeline
        try:
            peaks = flops.peak(kind)
        except KeyError:
            peaks = None
        run = SimpleNamespace(
            timeline=timeline, counts=out["counts"], config=config, traffic=traffic,
            counters={k: after[k] - before[k] for k in after}, peaks=peaks,
            window_s=timeline.window_s)
        metrics = {}
        for m in spec.per_layer(bench, workload):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=timeline.busy_s(), window_s=timeline.window_s)
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": timeline.top_device_ops(),
                                 "idle_gaps": timeline.idle_gaps()})
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {}
        for m in spec.end_to_end(bench, workload):
            if m["name"] not in values:
                if cuda:
                    raise KeyError(f"{workload} reports no {m['name']!r}")
                continue  # a device reading, which a CPU run has not
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result.update(metrics=metrics, device=device_info)
    if readings:
        result["readings"] = readings  # numbers the check reports but holds to no limit
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec

    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), chips)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    result["card"] = card_line()
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print(f"card: {result['card']}", file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, value in result.get("readings", {}).items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
