"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names, and the reference loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"bts_tpu_torch": 1, "bts_tpu_torch.ops": 1,
                                         "jaxtyping": 1, "numpy": 1})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"bts_tpu.models": 1, "jax": 1, "flax.linen": 1})
    assert run.forbidden_modules() == ["bts_tpu", "flax", "jax"]


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_imports_nothing_of_the_program():
    tops = _python(
        "import sys, benchmark.reference.model, "
        "benchmark.reference.lowp, benchmark.weights, benchmark.compare, benchmark.flops, "
        "benchmark.trace, benchmark.reduce; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert "bts_tpu_torch" not in tops and "bts_tpu" not in tops and "jax" not in tops


def test_a_run_loads_no_jax():
    found = _python(
        "import sys, time, torch, pytest\n"
        "from benchmark import run, spec\n"
        "from benchmark.tests import tiny\n"
        "mp = pytest.MonkeyPatch(); tiny.shrink(mp)\n"
        "run.execute('nyu-d161-serve-b8', 1, 0.2, False, torch.device('cpu'), "
        "t0=time.perf_counter())\n"
        "print(run.forbidden_modules(), 'bts_tpu_torch' in sys.modules)")
    assert found == "[] True"
