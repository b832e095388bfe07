"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources export plain C functions, so they compile without PyTorch's
headers (seconds, not minutes). Each source compiles to an object in its own
nvcc process, all started together; one more nvcc links them into a shared
library named by a hash of the sources, the headers they share (``*.cuh``)
and the flags. In a source checkout it goes to ``build/kernels/`` at the
repository root (git-ignored); an installed package, whose parent directory
is site-packages, builds into the per-user cache
(``$XDG_CACHE_HOME/bts_tpu_torch/kernels``, by default
``~/.cache/bts_tpu_torch/kernels``). It is built at first use in a process.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def build_dir(root: Path = Path(__file__).resolve().parents[2]) -> Path:
    """``build/kernels`` under ``root`` when it is a source checkout (it holds
    ``pyproject.toml``), else the per-user cache directory."""
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "bts_tpu_torch" / "kernels"


BUILD_DIR = build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_LIB = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc under torch's CUDA_HOME, else on PATH; raises if neither."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.is_file():
            return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the CUDA "
            "kernels in bts_tpu_torch/csrc cannot be built"
        )
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbts_kernels_{digest.hexdigest()[:16]}.so"


def _check(cmd, proc) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}")
    return err


def build(ptxas_report: bool = False) -> Path:
    """Compile csrc/*.cu into one shared library unless it already exists.
    With ``ptxas_report``, print what ``-Xptxas -v`` says of each kernel
    (registers, shared memory, spills)."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    report = ["-Xptxas", "-v"] if ptxas_report else []
    cmds = [[nvcc, *NVCC_FLAGS, *report, "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objs, _sources())]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        for cmd, proc, src in zip(cmds, procs, _sources()):
            err = _check(cmd, proc)
            if ptxas_report:
                print(f"ptxas -v, {src.name}:\n{err}", end="")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _check(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernels, with C signatures set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # plane_eq, out, B, H, W, r, inv_scale, out_bf16, stream
        lib.lpg_forward.argtypes = [ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.lpg_forward.restype = i32
        # plane_eq, grad, dplane, B, H, W, r, grad strides (b, y, x), inv_scale,
        # scale, grad_bf16, stream
        lib.lpg_backward.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64,
                                     ctypes.c_float, i32, i32, ptr]
        lib.lpg_backward.restype = i32
        strided = [ptr, i64, i64, i64]  # a map's pointer and its (b, h, w) strides
        params = [ptr] * 6  # s1, b1, w1t, s2, b2, w2t (eo: w2qt), K-major
        sizes = [i32] * 6  # B, H, W (eo: U), C, Cmid, G
        for dt in ("f32", "bf16"):
            taps = getattr(lib, f"fused_dense_taps_{dt}")
            taps.argtypes = [*strided, *params, *strided, *sizes, ptr]
            taps.restype = i32
            eo = getattr(lib, f"fused_dense_eo_{dt}")
            eo.argtypes = [*strided, *strided, *params, *strided, i64, *sizes, ptr]
            eo.restype = i32
        _LIB = lib
    return _LIB
