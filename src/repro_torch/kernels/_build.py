"""Build the CUDA kernels at first use and load them with ``ctypes``.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``) into an object,
all sources at once in parallel, and links them into one shared library
with a plain C interface.  The library lands in ``build/repro_torch/``
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
    "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of the C entry points (pointers and the stream as c_void_p, so
#: ctypes never truncates them to 32 bits)
_SHARED = [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P,  # dtype .. work_kblk
           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I]  # M K N bm bk TN KC S vec_a vec_b
_GRID = _SHARED[:11] + [_I] + _SHARED[12:]  # (row_starts, work_kblk) -> (idx, kdim)
_EPILOGUE = [_P, _P, _I, _P, _I]  # bias residual act mask bn
SIGNATURES = {
    "td_spmm_planned": _SHARED + [_P],  # stream
    "td_spmm_fused": _SHARED + _EPILOGUE + [_P],
    "td_spmm_grid_planned": _GRID + [_P],
    "td_spmm_grid_fused": _GRID + _EPILOGUE + [_P],
    # dtype x s0 s1 M K bm bk out stream
    "td_block_zero_mask": [_I, _P, _LL, _LL, _I, _I, _I, _I, _P, _P],
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


def _run(cmds: list[list[str]], logdir: str) -> None:
    """Run the commands side by side (their output to files in ``logdir``,
    so no pipe fills while another is read); raise with every failure's
    output."""
    logs = [open(os.path.join(logdir, f"cmd{i}.log"), "w+") for i in range(len(cmds))]
    try:
        procs = [subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT)
                 for c, log in zip(cmds, logs)]
        failed = []
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.wait() != 0:
                log.seek(0)
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log.read()}")
    finally:
        for log in logs:
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels (unless a library of the same hash exists)."""
    out = BUILD_DIR / f"libtensordash_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc, objs = _nvcc(), []
        compiles = []
        for src in _sources():
            objs.append(os.path.join(tmpdir, src.stem + ".o"))
            compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
        _run(compiles, tmpdir)
        lib = os.path.join(tmpdir, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], tmpdir)
        os.replace(lib, out)
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
