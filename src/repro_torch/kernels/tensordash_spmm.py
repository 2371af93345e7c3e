"""TensorDash planned block-sparse matmul on Hopper (port of
``repro/kernels/tensordash_spmm.py``).

Planning metadata is plain torch ops on the plan's device: a block-nonzero
mask is compacted into ``(nnz [Mb], idx [Mb, Kb])`` (cumsum plus scatter;
the tail repeats the last effectual index) and flattened into the CSR work
queue ``(row_starts [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])``, all
int32 and equal to the JAX package's arrays.

The two wrappers run the CUDA kernels of ``csrc/tensordash_spmm.cu``:

* :func:`tensordash_matmul_planned` — ``C = A @ B`` over the plan
  (replaces the Pallas ``_ragged_kernel`` and, for ``compact_grid``
  ``"v2"``/``"v1"``, ``_kernel``);
* :func:`tensordash_matmul_fused` — the same plus the fp32 epilogue
  ``act(acc + bias) + residual`` and the emitted int8 ``[Mb, Nb]`` output
  block-nonzero mask (replaces ``_ragged_fused_kernel`` and
  ``_fused_kernel``).

``"ragged"`` walks the plan's CSR work queue; ``"v2"``/``"v1"`` read
``idx[m, k]`` directly over a K bound of ``max(max(nnz), 1)`` (reduced on
the card, never read on the host) or ``Kb``.  The three families give
bit-identical results.  On a CPU tensor a wrapper runs the plain executor
of :mod:`.ref`; on a CUDA tensor it launches its kernel or raises.
:func:`launch_counts` counts the launches per wrapper and grid family.
:func:`plan_blocks` finds the effectual blocks with
:func:`~repro_torch.kernels.block_mask.block_zero_mask`.
"""
from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_mask import block_zero_mask

__all__ = [
    "COMPACT_GRID_MODES",
    "FUSED_ACTIVATIONS",
    "plan_blocks",
    "plan_blocks_csr",
    "plan_to_mask",
    "plan_from_mask",
    "plan_from_mask_csr",
    "plan_workqueue",
    "dense_plan",
    "dense_plan_csr",
    "planned_grid_steps",
    "tensordash_matmul_planned",
    "tensordash_matmul_fused",
    "launch_counts",
    "reset_launch_counts",
]

#: epilogue activations the fused kernel understands
FUSED_ACTIVATIONS = ("none", "relu", "squared_relu")
#: valid ``compact_grid`` modes: v3 ragged work queue / v2 / v1
COMPACT_GRID_MODES = ("ragged", "v2", "v1")
CompactGrid = Literal["ragged", "v2", "v1"]

_I32 = torch.int32


def _check_compact_grid(value) -> CompactGrid:
    """Normalize a grid-mode value to its canonical literal, rejecting
    anything unrecognized (legacy ``True``/``False`` mean v2/v1)."""
    if isinstance(value, str) and value in COMPACT_GRID_MODES:
        return value
    if value is True:
        return "v2"
    if value is False:
        return "v1"
    raise ValueError(
        f"compact_grid={value!r} not one of {COMPACT_GRID_MODES} "
        '("ragged" = v3 work queue, "v2"/True = max(nnz) grid, '
        '"v1"/False = full gated grid)'
    )


# ---------------------------------------------------------------------------
# planning metadata
# ---------------------------------------------------------------------------


def _mask_to_plan(nonzero: torch.Tensor):
    """Compact a block-nonzero mask ``[Mb, Kb]`` into ``(nnz, idx)``: a
    cumsum gives each effectual block its slot, a scatter writes it
    (ineffectual blocks land in a dropped extra column), and the tail repeats
    the last effectual index."""
    nonzero = nonzero != 0
    mb, kb = nonzero.shape
    dev = nonzero.device
    nnz = nonzero.sum(dim=1, dtype=_I32)
    slot = torch.cumsum(nonzero, dim=1, dtype=_I32) - 1
    target = torch.where(nonzero, slot, kb).long()
    ks = torch.arange(kb, dtype=_I32, device=dev).expand(mb, kb)
    idx = torch.zeros((mb, kb + 1), dtype=_I32, device=dev).scatter_(1, target, ks)[:, :kb]
    pos = torch.arange(kb, device=dev)[None, :]
    last = idx.gather(1, torch.clamp_min(nnz - 1, 0).long()[:, None])
    idx = torch.where(pos < torch.clamp_min(nnz, 1)[:, None], idx, last)
    return nnz, idx.contiguous()


def plan_blocks(a: torch.Tensor, bm: int, bk: int):
    """Compacted effectual K-block lists of ``a``'s ``bm x bk`` blocks:
    ``(nnz [Mb], idx [Mb, Kb])`` int32."""
    return _mask_to_plan(block_zero_mask(a, bm=bm, bk=bk))


def plan_workqueue(nnz: torch.Tensor, idx: torch.Tensor):
    """Flatten ``(nnz, idx)`` into the v3 CSR work queue ``(row_starts
    [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])``.  Every row owns
    ``max(nnz, 1)`` items, so an all-zero row keeps one gated item; the tail
    past ``row_starts[-1]`` is zero and never visited."""
    mb, kb = idx.shape
    dev = idx.device
    flat = mb * kb
    work = torch.clamp_min(nnz, 1).to(_I32)
    row_starts = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                            torch.cumsum(work, dim=0, dtype=_I32)])
    j = torch.arange(kb, dtype=_I32, device=dev)[None, :]
    pos = torch.where(j < work[:, None], row_starts[:-1, None] + j, flat).long().reshape(-1)
    rows = torch.arange(mb, dtype=_I32, device=dev)[:, None].expand(mb, kb).reshape(-1)

    def scatter(values):
        buf = torch.zeros(flat + 1, dtype=_I32, device=dev)
        return buf.scatter_(0, pos, values)[:flat]

    return row_starts, scatter(rows), scatter(idx.to(_I32).reshape(-1))


def plan_blocks_csr(a: torch.Tensor, bm: int, bk: int):
    """:func:`plan_blocks` plus the work queue:
    ``(nnz, idx, row_starts, work_row, work_kblk)``."""
    nnz, idx = plan_blocks(a, bm, bk)
    return (nnz, idx) + plan_workqueue(nnz, idx)


def plan_to_mask(nnz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The block-nonzero mask ``[Mb, Kb]`` (bool) a plan was compacted from."""
    mb, kb = idx.shape
    valid = (torch.arange(kb, device=idx.device)[None, :] < nnz[:, None]).to(torch.int8)
    mask = torch.zeros((mb, kb), dtype=torch.int8, device=idx.device)
    return mask.scatter_reduce_(1, idx.long(), valid, reduce="amax") != 0


def plan_from_mask(mask: torch.Tensor, *, coarsen: int = 1):
    """Plan ``(nnz, idx)`` from an emitted ``[Mb, Nb]`` mask, metadata only.
    ``coarsen`` groups that many adjacent mask columns into one consumer K
    block (effectual iff any member is)."""
    mb, nb = mask.shape
    if nb % coarsen:
        raise ValueError(f"mask with {nb} columns cannot coarsen by {coarsen}")
    nonzero = mask != 0
    if coarsen > 1:
        nonzero = nonzero.reshape(mb, nb // coarsen, coarsen).any(dim=2)
    return _mask_to_plan(nonzero)


def plan_from_mask_csr(mask: torch.Tensor, *, coarsen: int = 1):
    """:func:`plan_from_mask` plus the work queue."""
    nnz, idx = plan_from_mask(mask, coarsen=coarsen)
    return (nnz, idx) + plan_workqueue(nnz, idx)


def planned_grid_steps(nnz, kb: int, mb: int, nb: int, *, compact_grid="ragged") -> int:
    """Grid steps the planned kernel issues, the TPU kernel's "time": v1
    ``Mb * Nb * Kb``, v2 ``Mb * Nb * max(nnz, 1)``, ragged ``Nb *
    sum(max(nnz, 1))``.  A report helper: it reads ``nnz`` on the host (one
    copy); use ``SparsityPlan.grid_steps`` for a plan's cached count."""
    compact_grid = _check_compact_grid(compact_grid)
    nnz_h = np.asarray(torch.as_tensor(nnz).cpu())
    if compact_grid == "ragged":
        return nb * int(np.maximum(nnz_h, 1).sum())
    kdim = kb if compact_grid == "v1" else max(int(nnz_h.max(initial=0)), 1)
    return mb * nb * kdim


@functools.lru_cache(maxsize=256)
def dense_plan(mb: int, kb: int, device="cpu"):
    """The trivial all-effectual plan ``nnz = Kb``, ``idx = arange``, as
    int32 tensors on ``device``.  Memoized per ``(mb, kb, device)`` so a
    known-dense operand (the FFN gate's input) costs no host-to-device copy
    per call; the tensors are shared, so callers never edit them."""
    dev = torch.device(device)
    nnz = torch.full((mb,), kb, dtype=_I32, device=dev)
    idx = torch.arange(kb, dtype=_I32, device=dev).expand(mb, kb).contiguous()
    return nnz, idx


@functools.lru_cache(maxsize=256)
def dense_plan_csr(mb: int, kb: int, device="cpu"):
    """:func:`dense_plan` plus its closed-form work queue (``row_starts =
    m * Kb``, every ``(m, k)`` pair in row-major order), memoized per
    ``(mb, kb, device)``."""
    dev = torch.device(device)
    nnz, idx = dense_plan(mb, kb, dev)
    row_starts = torch.arange(mb + 1, dtype=_I32, device=dev) * kb
    work_row = torch.arange(mb, dtype=_I32, device=dev).repeat_interleave(kb)
    work_kblk = idx.reshape(-1).clone()
    return nnz, idx, row_starts, work_row, work_kblk


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"none": 0, "relu": 1, "squared_relu": 2}
_THREADS, _MAX_PER_THREAD = 256, 8  # must match csrc/tensordash_spmm.cu
_SMEM_FLOATS = 48 * 1024 // 4


def _divisor_at_most(dim: int, cap: int) -> int:
    b = max(1, min(cap, dim))
    while dim % b:
        b -= 1
    return b


def kernel_tile(bm: int, bk: int, bn: int) -> tuple[int, int]:
    """The CUDA kernel's column tile ``TN`` (a divisor of ``bn``, at most 32,
    with ``bm * TN`` accumulators spread over the CTA's threads) and its
    shared-memory K chunk ``KC`` (at most ``bk``, within 48 KB)."""
    if bm > _THREADS * _MAX_PER_THREAD:
        raise ValueError(f"bm={bm} exceeds the CUDA kernel's {_THREADS * _MAX_PER_THREAD} rows")
    tn = _divisor_at_most(bn, min(32, _THREADS * _MAX_PER_THREAD // bm))
    kc = min(bk, (_SMEM_FLOATS - bm) // (bm + tn + 1))
    if kc >= 32:
        kc -= kc % 32
    if kc < 1:
        raise ValueError(f"block geometry bm={bm} bn={bn} does not fit shared memory")
    return tn, kc


def kernel_splits(tiles: int, kb: int, sms: int) -> int:
    """How many contiguous shares ``S`` each block row's work queue is cut
    into: enough CTAs for about four per SM when the output has fewer tiles
    than that (the skinny decode products), at most ``Kb`` (the longest a
    queue segment can be, known without reading ``nnz`` on the host)."""
    return max(1, min(kb, -(-4 * sms // tiles)))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_splits(m: int, k: int, n: int, bm: int, bk: int, bn: int, device) -> int:
    """The split count ``S`` a launch of ``[m, k] @ [k, n]`` at ``(bm, bk,
    bn)`` uses on ``device``'s card (the same for every grid family)."""
    tn, _ = kernel_tile(bm, bk, bn)
    return kernel_splits((n // tn) * (m // bm), k // bk, _sm_count(torch.device(device).index or 0))


def _vec_ok(t: torch.Tensor, lead_stride: int, *extents: int) -> int:
    """1 when 16-byte loads along ``t``'s unit-stride dimension stay aligned:
    the base pointer, the other stride and every tile extent along it are
    multiples of 16 bytes' worth of elements."""
    v = 16 // t.element_size()
    return int(t.data_ptr() % 16 == 0 and lead_stride % v == 0 and all(x % v == 0 for x in extents))


def _meta(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=device).contiguous()


def check_launch(m: int, bm: int, bk: int, bn: int) -> None:
    """Raise ``ValueError`` for a geometry the CUDA kernels cannot take:
    more than 65535 block rows (the grid's y extent), or a tile that does
    not fit the CTA (:func:`kernel_tile`)."""
    if m // bm > 65535:
        raise ValueError(f"{m // bm} block rows exceed the CUDA grid's y extent")
    kernel_tile(bm, bk, bn)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


#: kernel launches since the last :func:`reset_launch_counts`, per wrapper
#: and grid family ("tensordash_matmul_planned" is the ragged family)
_LAUNCHES: dict[str, int] = {}
_COUNTERS = tuple(f"{w}{'' if g == 'ragged' else f'[{g}]'}"
                  for w in ("tensordash_matmul_planned", "tensordash_matmul_fused")
                  for g in COMPACT_GRID_MODES)


def _launched(wrapper: str, grid: str) -> None:
    _LAUNCHES[wrapper if grid == "ragged" else f"{wrapper}[{grid}]"] += 1


def _launch_args(nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue):
    """Validate one CUDA launch and allocate its output.  Returns ``(lead,
    tiling, out, keep)``: the C arguments up to the plan's (for ragged
    ``row_starts, work_kblk``; for v1/v2 ``idx, kdim`` with ``kdim = 0``
    meaning v2's bound reduced on the card), the tiling arguments, the
    output, and the tensors behind the pointers, which the caller holds
    until the call returns."""
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"CUDA kernel takes float32 or bfloat16 operands of one dtype, got {a.dtype}, {b.dtype}")
    if out_dtype not in (None, a.dtype):
        raise TypeError(f"CUDA kernel writes {a.dtype}, not out_dtype={out_dtype}")
    m, k, n = ref._check_blocks(a, b, bm, bk, bn)
    check_launch(m, bm, bk, bn)
    if grid == "ragged":
        if workqueue is None:
            workqueue = plan_workqueue(_meta(nnz, a.device), _meta(idx, a.device))
        row_starts, _, work_kblk = workqueue
        plan_t = (_meta(row_starts, a.device), _meta(work_kblk, a.device))
        plan_args = tuple(t.data_ptr() for t in plan_t)
    else:
        plan_t = (_meta(idx, a.device),)
        if tuple(plan_t[0].shape) != (m // bm, k // bk):
            raise ValueError(f"idx {tuple(plan_t[0].shape)} is not the plan of [{m}, {k}] at ({bm}, {bk})")
        plan_args = (plan_t[0].data_ptr(), k // bk if grid == "v1" else 0)
    nnz_t = _meta(nnz, a.device)
    tn, kc = kernel_tile(bm, bk, bn)
    splits = launch_splits(m, k, n, bm, bk, bn, a.device)
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    vec_a = (_vec_ok(a, sam, bk, kc) if sak == 1
             else _vec_ok(a, sak, bm) if sam == 1 else 0)
    vec_b = _vec_ok(b, sbk, tn) if sbn == 1 else 0
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
               if splits > 1 else None)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lead = (_DTYPE_CODE[a.dtype], a.data_ptr(), sam, sak, b.data_ptr(), sbk, sbn, out.data_ptr(),
            None if partial is None else partial.data_ptr(), nnz_t.data_ptr(), *plan_args)
    tiling = (m, k, n, bm, bk, tn, kc, splits, vec_a, vec_b)
    return lead, tiling, out, (nnz_t, plan_t, partial)


def tensordash_matmul_planned(nnz, idx, a: torch.Tensor, b: torch.Tensor, *,
                              bm: int = 128, bk: int = 512, bn: int = 128,
                              out_dtype=None, compact_grid="ragged", workqueue=None):
    """Block-sparse ``a @ b`` given a precomputed block plan.  ``a`` and ``b``
    may be strided views (the side-B LM head passes ``lm_head.T``); the
    output is contiguous.  ``workqueue`` optionally supplies the plan's
    ``(row_starts, work_row, work_kblk)`` (ragged only; v1/v2 read ``idx``)."""
    grid = _check_compact_grid(compact_grid)
    if a.device.type == "cpu":  # every family runs the same schedule
        return ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    lead, tiling, out, keep = _launch_args(nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue)
    from repro_torch.kernels import _build

    lib = _build.library()
    entry = lib.td_spmm_planned if grid == "ragged" else lib.td_spmm_grid_planned
    with torch.cuda.device(a.device):
        rc = entry(*lead, *tiling, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "tensordash_matmul_planned")
    _launched("tensordash_matmul_planned", grid)
    return out


def tensordash_matmul_fused(nnz, idx, a: torch.Tensor, b: torch.Tensor,
                            bias: torch.Tensor | None = None,
                            residual: torch.Tensor | None = None, *,
                            activation: str = "none", bm: int = 128, bk: int = 512,
                            bn: int = 128, out_dtype=None, compact_grid="ragged",
                            workqueue=None):
    """Planned ``act(a @ b + bias) + residual`` with the epilogue applied to
    the fp32 accumulator, plus the emitted output mask.  Returns ``(out
    [M, N], mask int8 [M/bm, N/bn])``."""
    if activation not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {FUSED_ACTIVATIONS}")
    grid = _check_compact_grid(compact_grid)
    if a.device.type == "cpu":
        return ref.tensordash_matmul_fused_ref(
            nnz, idx, a, b, bias, residual, bm=bm, bk=bk, bn=bn,
            activation=activation, out_dtype=out_dtype,
        )
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    lead, tiling, out, keep = _launch_args(nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue)
    m, _, n = tiling[:3]
    bias32 = None
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
        bias32 = bias.to(device=a.device, dtype=torch.float32).contiguous()
    if residual is not None:
        if residual.shape != (m, n) or residual.dtype != a.dtype or residual.device != a.device:
            raise ValueError(f"residual must be [{m}, {n}] {a.dtype} on {a.device}")
        residual = residual.contiguous()
    mask = torch.zeros((m // bm, n // bn), dtype=torch.int8, device=a.device)
    from repro_torch.kernels import _build

    lib = _build.library()
    entry = lib.td_spmm_fused if grid == "ragged" else lib.td_spmm_grid_fused
    with torch.cuda.device(a.device):
        rc = entry(
            *lead, *tiling,
            None if bias32 is None else bias32.data_ptr(),
            None if residual is None else residual.data_ptr(),
            _ACT_CODE[activation], mask.data_ptr(), bn,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(rc, "tensordash_matmul_fused")
    _launched("tensordash_matmul_fused", grid)
    return out, mask


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`: per
    wrapper and grid family (the ragged family under the bare wrapper
    name, v2/v1 as ``"<wrapper>[v2]"``) and ``"block_zero_mask"``."""
    return {**{c: _LAUNCHES[c] for c in _COUNTERS}, "block_zero_mask": block_zero_mask.launches}


def reset_launch_counts() -> None:
    _LAUNCHES.update(dict.fromkeys(_COUNTERS, 0))
    block_zero_mask.launches = 0


reset_launch_counts()
