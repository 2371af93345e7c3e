"""Build the CUDA kernels at first use and load them with ``ctypes``.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface.  The library lands in ``build/repro_torch/``
at the root of the checkout, named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as is.  Nothing here
runs at import: :func:`library` builds on its first call, which is the first
kernel launch.  A failed build raises.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of the C entry points (pointers and the stream as c_void_p, so
#: ctypes never truncates them to 32 bits)
_SHARED = [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P,  # dtype .. work_kblk
           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I]  # M K N bm bk TN KC S vec_a vec_b
SIGNATURES = {
    "td_spmm_planned": _SHARED + [_P],  # stream
    "td_spmm_fused": _SHARED + [_P, _P, _I, _P, _I, _P],  # bias residual act mask bn stream
}

_LIB: ctypes.CDLL | None = None
#: seconds the last build (or load) took; read by ``chip_smoke.py``
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (unless a library of the same hash exists)."""
    out = BUILD_DIR / f"libtensordash_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB, build_seconds
    if _LIB is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _LIB = lib
    return _LIB
