"""Build the CUDA kernels at first use and load them with ``ctypes``.

``nvcc`` compiles each ``csrc/*.cu`` (with the ``*.cuh`` headers they
include) for Hopper (``sm_90a``) into an object, all sources at once in
parallel, and links them into one shared library with a plain C interface.
The library lands in ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources, headers and flags, so an edited source is
rebuilt and an unchanged one is loaded as is.  Nothing here
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class SpmmArgs(ctypes.Structure):
    """The launch arguments of ``td_spmm`` (``Args`` in
    ``csrc/tensordash_spmm.cu``; keep the two in step).  Pointers are
    ``c_void_p``, so ctypes never truncates them to 32 bits."""

    _fields_ = [
        ("a", _P), ("sam", _LL), ("sak", _LL),
        ("b", _P), ("sbk", _LL), ("sbn", _LL),
        ("out", _P), ("partial", _P), ("counters", _P),
        ("nnz", _P), ("row_starts", _P), ("work_kblk", _P), ("idx", _P),
        ("bias", _P), ("residual", _P), ("mask", _P),
        *((name, _I) for name in (
            "kdim", "M", "K", "N", "bm", "bk", "bn", "rows", "TN", "KC", "S", "stages",
            "swap", "wp", "wq", "mt", "nt", "a_kmaj", "a_vec", "b_kmaj", "b_vec",
            "activation", "out_type")),
    ]


class PlanArgs(ctypes.Structure):
    """The launch arguments of ``td_plan`` (``TdPlanArgs`` in
    ``csrc/block_mask.cu``; keep the two in step)."""

    _fields_ = [
        ("x", _P), ("s0", _LL), ("s1", _LL), ("fnnz", _P), ("fidx", _P), ("mask", _P),
        ("nnz", _P), ("idx", _P), ("row_starts", _P), ("work_row", _P), ("work_kblk", _P),
        ("counter", _P),
        *((name, _I) for name in ("mode", "dtype", "R", "C", "bm", "bk", "vec")),
    ]


class ScheduleArgs(ctypes.Structure):
    """The launch arguments of ``td_schedule`` (``TdScheduleArgs`` in
    ``csrc/schedule.cu``; keep the two in step)."""

    _fields_ = [
        ("z", _P), ("sel", _P), ("advance", _P), ("n_cycles", _P), ("work", _P), ("T", _LL),
        *((name, _I) for name in ("S", "N", "depth", "n_options", "n_levels", "vec", "n_segs", "seg_rows",
                                  "overlap")),
        ("opt_step", _I * 8), ("opt_rot", _I * 8), ("level_mask", ctypes.c_uint * 16),
    ]


class TileArgs(ctypes.Structure):
    """The launch arguments of ``td_tile`` (``TdTileArgs`` in
    ``csrc/schedule.cu``; keep the two in step)."""

    _fields_ = [
        ("z", _P), ("offset", _P), ("t", _P), ("cycles", _P),
        *((name, _I) for name in ("G", "R", "N", "depth", "n_options", "n_levels", "pack", "stage_words")),
        ("opt_step", _I * 8), ("opt_rot", _I * 8), ("level_mask", ctypes.c_uint * 16),
    ]


class SampleArgs(ctypes.Structure):
    """The launch arguments of ``td_sample`` (``TdSampleArgs`` in
    ``csrc/sample.cu``; keep the two in step)."""

    _fields_ = [
        ("rows", _P), ("row_stride", _LL), ("col_stride", _LL), ("keys", _P), ("good", _P), ("tokens", _P),
        ("best", _P), ("arrived", _P), ("temperature", ctypes.c_float), ("inv", ctypes.c_float),
        *((name, _I) for name in ("reciprocal", "B", "V", "pad_id", "chunk")),
    ]


class NormalArgs(ctypes.Structure):
    """The launch arguments of ``td_normal`` (``TdNormalArgs`` in
    ``csrc/normal.cu``; keep the two in step)."""

    _fields_ = [
        ("out", _P), ("n", _LL), ("offset", _LL), ("shape", _LL * 6), ("stride", _LL * 6),
        ("k0", ctypes.c_uint), ("k1", ctypes.c_uint), ("scale", ctypes.c_float),
        *((name, _I) for name in ("ndim", "out_bf16", "grid")),
    ]


#: argtypes of the C entry points
SIGNATURES = {
    # dtype fused grid args stream
    "td_spmm": [_I, _I, _I, ctypes.POINTER(SpmmArgs), _P],
    # args stream
    "td_plan": [ctypes.POINTER(PlanArgs), _P],
    "td_schedule": [ctypes.POINTER(ScheduleArgs), _P],
    "td_tile": [ctypes.POINTER(TileArgs), _P],
    "td_sample": [ctypes.POINTER(SampleArgs), _P],
    "td_normal": [ctypes.POINTER(NormalArgs), _P],
}

_LIB: ctypes.CDLL | None = None
#: seconds the last build (or load) took; read by ``chip_smoke.py``
build_seconds: float | None = None
#: ptxas's report of the last build (registers, shared memory, spills per
#: kernel), kept beside the library; read by ``chip_smoke.py``
ptxas_report: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]], logdir: str) -> str:
    """Run the commands side by side (their output to files in ``logdir``,
    so no pipe fills while another is read); raise with every failure's
    output, else return their output."""
    logs = [open(os.path.join(logdir, f"cmd{i}.log"), "w+") for i in range(len(cmds))]
    try:
        procs = [subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT)
                 for c, log in zip(cmds, logs)]
        failed, text = [], []
        for cmd, proc, log in zip(cmds, procs, logs):
            proc.wait()
            log.seek(0)
            text.append(log.read())
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text[-1]}")
    finally:
        for log in logs:
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(text)


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
        report = _run(compiles, tmpdir)
        lib = os.path.join(tmpdir, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], tmpdir)
        out.with_suffix(".ptxas.txt").write_text(report)
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB, build_seconds, ptxas_report
    if _LIB is None:
        t0 = time.perf_counter()
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        report = path.with_suffix(".ptxas.txt")
        ptxas_report = report.read_text() if report.exists() else ""
        _LIB = lib
    return _LIB
