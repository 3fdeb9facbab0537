"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

The sources under ``csrc/`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The file name carries a hash of the source and the flags,
so an edited source is never served by a stale library.  Nothing here runs
at import time: the CPU tests import every module of the package, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each source: name -> argtypes (all return cudaError_t);
# every source also exports ``const char* error_string(int)``
SIGNATURES: Dict[str, Dict[str, list]] = {
    "eb_kernels": {
        "eb_bucketize": [_P, _P, _P, _I, _I, _I, _P],
        "eb_ternary_match": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "eb_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    },
    "lb_dm_kernels": {
        "lb_lookup": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        "lb_lookup_plan": [_I, _I, _I, _I, _I, _P],
        "bnn_popcount_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "paged_attention": {
        "paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "linear": {
        "linear_weight_map": [_P, _I, _I, _P],
        "linear": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "moe": {
        "moe_down_combine": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc/ptxas output of the last build
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or in "
                       "CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, str, float]]:
    """Start ``nvcc`` for one source: (process, temp output, start time),
    or None when its library is already built."""
    if _lib_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, started) -> None:
    """Wait for ``_start``'s build, keep its log, publish the library."""
    if started is None:
        return
    proc, tmp, t0 = started
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))


def build_all() -> Dict[str, float]:
    """Build every source at once (one nvcc each, started together)."""
    started = {name: _start(name) for name in SIGNATURES}
    errors = []
    for name, job in started.items():  # wait for every nvcc, then report
        try:
            _finish(name, job)
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    return dict(BUILD_SECONDS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({err})")
