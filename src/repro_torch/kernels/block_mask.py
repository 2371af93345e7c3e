"""Block zero-mask and the one-launch planner (port of
``repro/kernels/block_mask.py`` and of the plan compaction of
``repro/kernels/tensordash_spmm.py``).

:func:`block_zero_mask` maps ``x [M, K]`` to int8 ``[M/bm, K/bk]``, 1 where
a ``bm x bk`` block has any nonzero: the TensorDash front end's Z vector at
block granularity.  On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.block_any_nonzero`; on a CUDA tensor it
launches ``csrc/block_mask.cu`` in mode ``mask``.

The same kernel builds a whole CSR plan ``(nnz, idx, row_starts, work_row,
work_kblk)`` in one launch (:func:`launch_planner`): from an operand's
values (mode ``values``, behind ``plan_blocks_csr``), from an emitted block
mask (``emitted``, behind ``plan_from_mask_csr``) or from a forward plan
(``transpose``, behind ``transpose_plan_csr``).  Those functions, in
:mod:`.tensordash_spmm`, run the chains of :mod:`.ref` on a CPU tensor and
this launch on a CUDA tensor; a failed build or launch raises.
:data:`COUNTERS` names the launch count of each mode, kept in
:data:`LAUNCHES` (``tensordash_spmm.launch_counts`` reports them).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

__all__ = ["block_zero_mask", "launch_planner", "COUNTERS", "LAUNCHES"]

#: the planner's modes, in the kernel's numbering
MODES = ("mask", "values", "emitted", "transpose")
#: launch counter of each mode: mode ``mask`` is ``block_zero_mask``
COUNTERS = {"mask": "block_zero_mask", "values": "planner[values]",
            "emitted": "planner[emitted]", "transpose": "planner[transpose]"}
#: launches per counter since ``tensordash_spmm.reset_launch_counts``
LAUNCHES = dict.fromkeys(COUNTERS.values(), 0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK_DTYPES = (torch.int8, torch.uint8, torch.bool)
# must match csrc/block_mask.cu
_STAGE_FLAGS = 24576  # the most K blocks a planned row may have
_I32 = torch.int32


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device has no
    kernel and raises ``ValueError``."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _card_stream(dev: torch.device):
    """``dev``'s current stream as a raw ``cudaStream_t`` and a context that
    makes ``dev`` the current device."""
    return torch.cuda.current_stream(dev).cuda_stream, torch.cuda.device(dev)


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SMs of the card ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_operand(x: torch.Tensor, bm: int, bk: int) -> None:
    """Raise ``ValueError`` unless ``x`` is 2-D and ``bm x bk`` blocks tile it."""
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D operand, got {tuple(x.shape)}")
    if x.shape[0] % bm or x.shape[1] % bk:
        raise ValueError(f"operand {tuple(x.shape)} not divisible by block ({bm}, {bk})")


def _vec_ok(x: torch.Tensor, bm: int, bk: int) -> int:
    """1 when 16-byte loads along ``x``'s unit-stride dimension stay
    aligned for every block (the kernel walks columns unless ``x`` is a
    transposed view, whose rows are unit-stride)."""
    s0, s1 = x.stride()
    cols = not (s1 != 1 and s0 == 1)
    inner, si, so = (bk, s1, s0) if cols else (bm, s0, s1)
    v = 16 // x.element_size()
    return int(si == 1 and x.data_ptr() % 16 == 0 and inner % v == 0 and so % v == 0)


def launch_planner(mode: str, x: torch.Tensor, rows: int, cols: int, *, bm: int = 1, bk: int = 1,
                   fnnz: torch.Tensor | None = None):
    """One launch of the planner kernel on ``x``'s card.

    * ``mask``: ``x [rows * bm, cols * bk]`` -> int8 ``[rows, cols]``;
    * ``values``: the same operand -> its CSR plan;
    * ``emitted``: ``x`` an int8/bool mask ``[rows, cols * bk]``, ``bk``
      the coarsening -> its CSR plan;
    * ``transpose``: ``x`` the forward ``idx [cols, rows]`` and ``fnnz`` its
      ``nnz [cols]`` (int32, contiguous) -> the CSR plan of the transpose.

    A CSR plan is ``(nnz [rows], idx [rows, cols], row_starts [rows+1],
    work_row, work_kblk [rows*cols])``, int32 views of one allocation.
    Raises ``TypeError``/``ValueError`` for what the kernel does not take and
    ``RuntimeError`` when the launch fails."""
    from repro_torch.kernels import _build

    flat = rows * cols
    if not 0 < flat < 2**31:
        raise ValueError(f"planner: a [{rows}, {cols}] block grid is empty or too large")
    if mode != "mask" and cols > _STAGE_FLAGS:
        raise ValueError(f"planner: {cols} K blocks a row exceed the kernel's {_STAGE_FLAGS}")
    dev = x.device
    args = _build.PlanArgs(mode=MODES.index(mode), R=rows, C=cols, bm=bm, bk=bk)
    if mode == "transpose":
        if fnnz.device != dev or fnnz.dtype != _I32 or x.dtype != _I32:
            raise TypeError(f"transpose: the forward plan must be int32 on one device, got "
                            f"{fnnz.dtype} on {fnnz.device} and {x.dtype} on {dev}")
        if (fnnz.shape, x.shape) != ((cols,), (cols, rows)) or not (fnnz.is_contiguous()
                                                                    and x.is_contiguous()):
            raise ValueError(f"transpose: nnz {tuple(fnnz.shape)} and idx {tuple(x.shape)} must be "
                             "contiguous and of one plan")
        args.fnnz, args.fidx = fnnz.data_ptr(), x.data_ptr()
    else:
        args.x, (args.s0, args.s1) = x.data_ptr(), x.stride()
        if mode == "emitted":
            if x.dtype not in _MASK_DTYPES:
                raise TypeError(f"emitted: the planner takes an int8 or bool mask, got {x.dtype}")
        else:
            if x.dtype not in _DTYPE_CODE:
                raise TypeError(f"{COUNTERS[mode]}: the kernel takes float32 or bfloat16, got {x.dtype}")
            if bm * bk >= 2**31:
                raise ValueError(f"{COUNTERS[mode]}: a {bm} x {bk} block is too large")
            args.dtype, args.vec = _DTYPE_CODE[x.dtype], _vec_ok(x, bm, bk)
    if mode == "mask":
        out = torch.empty((rows, cols), dtype=torch.int8, device=dev)  # every byte written
        args.mask = out.data_ptr()
    else:
        buf = torch.empty(3 * flat + 2 * rows + 1, dtype=_I32, device=dev)  # every entry written
        idx, work_row, work_kblk = (buf[i * flat:(i + 1) * flat] for i in range(3))
        row_starts, nnz = buf[3 * flat:3 * flat + rows + 1], buf[3 * flat + rows + 1:]
        idx = idx.view(rows, cols)
        args.nnz, args.idx, args.row_starts = nnz.data_ptr(), idx.data_ptr(), row_starts.data_ptr()
        args.work_row, args.work_kblk = work_row.data_ptr(), work_kblk.data_ptr()
        out = (nnz, idx, row_starts, work_row, work_kblk)
    stream, current = _card_stream(dev)
    if mode == "values":  # slot 0 of the SpMM kernel's counter workspace (zero between launches)
        from repro_torch.kernels.tensordash_spmm import _arrivals

        args.counter = _arrivals(dev, stream, 1).data_ptr()
    lib = _build.library()
    with current:
        rc = lib.td_plan(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"{COUNTERS[mode]}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[COUNTERS[mode]] += 1
    return out


def block_zero_mask(x: torch.Tensor, *, bm: int = 128, bk: int = 512) -> torch.Tensor:
    """``[M, K] -> int8 [M/bm, K/bk]``; 1 where the block has any nonzero."""
    check_operand(x, bm, bk)
    if not on_card(x):
        return ref.block_any_nonzero(x, bm, bk)
    return launch_planner("mask", x, x.shape[0] // bm, x.shape[1] // bk, bm=bm, bk=bk)
