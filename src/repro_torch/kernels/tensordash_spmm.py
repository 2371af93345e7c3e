"""TensorDash planned block-sparse matmul on Hopper (port of
``repro/kernels/tensordash_spmm.py``).

Planning metadata is plain torch ops on the plan's device: a block-nonzero
mask is compacted into ``(nnz [Mb], idx [Mb, Kb])`` (cumsum plus scatter;
the tail repeats the last effectual index) and flattened into the CSR work
queue ``(row_starts [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])``, all
int32 and equal to the JAX package's arrays.

The two wrappers run the CUDA kernels of ``csrc/tensordash_spmm.cu``:

* :func:`tensordash_matmul_planned` — ``C = A @ B`` over the work queue
  (replaces the Pallas ``_ragged_kernel``);
* :func:`tensordash_matmul_fused` — the same plus the fp32 epilogue
  ``act(acc + bias) + residual`` and the emitted int8 ``[Mb, Nb]`` output
  block-nonzero mask (replaces ``_ragged_fused_kernel``).

On a CPU tensor a wrapper runs the plain executor of :mod:`.ref`; on a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its kernel
launches in its ``launches`` attribute.  Only the ``"ragged"`` grid family
has a CUDA kernel so far; ``"v2"``/``"v1"`` (the TPU A/B baselines) wait
for ROADMAP queue 2, items 4-5.
"""
from __future__ import annotations

import functools
from typing import Literal

import torch

from repro_torch.kernels import ref

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
    m, k = a.shape
    if m % bm or k % bk:
        raise ValueError(f"operand {tuple(a.shape)} not divisible by block ({bm}, {bk})")
    nz = a.reshape(m // bm, bm, k // bk, bk) != 0
    return _mask_to_plan(nz.any(dim=3).any(dim=1))


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


def _vec_ok(t: torch.Tensor, lead_stride: int, *extents: int) -> int:
    """1 when 16-byte loads along ``t``'s unit-stride dimension stay aligned:
    the base pointer, the other stride and every tile extent along it are
    multiples of 16 bytes' worth of elements."""
    v = 16 // t.element_size()
    return int(t.data_ptr() % 16 == 0 and lead_stride % v == 0 and all(x % v == 0 for x in extents))


def _meta(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=device).contiguous()


def _cuda_operands(nnz, idx, a, b, bm, bk, bn, out_dtype, workqueue):
    """Validate a CUDA launch; return its metadata tensors, tiling, split
    count, vector-load flags and the fp32 split workspace (or ``None``)."""
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"CUDA kernel takes float32 or bfloat16 operands of one dtype, got {a.dtype}, {b.dtype}")
    if out_dtype not in (None, a.dtype):
        raise TypeError(f"CUDA kernel writes {a.dtype}, not out_dtype={out_dtype}")
    m, k, n = ref._check_blocks(a, b, bm, bk, bn)
    if m // bm > 65535:
        raise ValueError(f"{m // bm} block rows exceed the CUDA grid's y extent")
    if workqueue is None:
        workqueue = plan_workqueue(_meta(nnz, a.device), _meta(idx, a.device))
    row_starts, _, work_kblk = workqueue
    tn, kc = kernel_tile(bm, bk, bn)
    splits = kernel_splits((n // tn) * (m // bm), k // bk, _sm_count(a.device.index or 0))
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    vec_a = (_vec_ok(a, sam, bk, kc) if sak == 1
             else _vec_ok(a, sak, bm) if sam == 1 else 0)
    vec_b = _vec_ok(b, sbk, tn) if sbn == 1 else 0
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
               if splits > 1 else None)
    return (m, k, n, _meta(nnz, a.device), _meta(row_starts, a.device),
            _meta(work_kblk, a.device), tn, kc, splits, vec_a, vec_b, partial)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _require_ragged(compact_grid) -> None:
    if _check_compact_grid(compact_grid) != "ragged":
        raise NotImplementedError(
            f"compact_grid={compact_grid!r}: only the ragged work-queue kernel "
            "is ported to CUDA (v2/v1 are ROADMAP queue 2, items 4-5)"
        )


def tensordash_matmul_planned(nnz, idx, a: torch.Tensor, b: torch.Tensor, *,
                              bm: int = 128, bk: int = 512, bn: int = 128,
                              out_dtype=None, compact_grid="ragged", workqueue=None):
    """Block-sparse ``a @ b`` given a precomputed block plan.  ``a`` and ``b``
    may be strided views (the side-B LM head passes ``lm_head.T``); the
    output is contiguous.  ``workqueue`` optionally supplies the plan's
    ``(row_starts, work_row, work_kblk)``."""
    if a.device.type == "cpu":
        _check_compact_grid(compact_grid)  # every family runs the same schedule
        return ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    _require_ragged(compact_grid)
    m, k, n, nnz_t, rs, wk, tn, kc, splits, vec_a, vec_b, partial = _cuda_operands(
        nnz, idx, a, b, bm, bk, bn, out_dtype, workqueue)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    from repro_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.td_spmm_planned(
            _DTYPE_CODE[a.dtype], a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            nnz_t.data_ptr(), rs.data_ptr(), wk.data_ptr(),
            m, k, n, bm, bk, tn, kc, splits, vec_a, vec_b,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(rc, "tensordash_matmul_planned")
    tensordash_matmul_planned.launches += 1
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
    if a.device.type == "cpu":
        _check_compact_grid(compact_grid)
        return ref.tensordash_matmul_fused_ref(
            nnz, idx, a, b, bias, residual, bm=bm, bk=bk, bn=bn,
            activation=activation, out_dtype=out_dtype,
        )
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    _require_ragged(compact_grid)
    m, k, n, nnz_t, rs, wk, tn, kc, splits, vec_a, vec_b, partial = _cuda_operands(
        nnz, idx, a, b, bm, bk, bn, out_dtype, workqueue)
    bias32 = None
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
        bias32 = bias.to(device=a.device, dtype=torch.float32).contiguous()
    if residual is not None:
        if residual.shape != (m, n) or residual.dtype != a.dtype or residual.device != a.device:
            raise ValueError(f"residual must be [{m}, {n}] {a.dtype} on {a.device}")
        residual = residual.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    mask = torch.zeros((m // bm, n // bn), dtype=torch.int8, device=a.device)
    from repro_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.td_spmm_fused(
            _DTYPE_CODE[a.dtype], a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            nnz_t.data_ptr(), rs.data_ptr(), wk.data_ptr(),
            m, k, n, bm, bk, tn, kc, splits, vec_a, vec_b,
            None if bias32 is None else bias32.data_ptr(),
            None if residual is None else residual.data_ptr(),
            _ACT_CODE[activation], mask.data_ptr(), bn,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(rc, "tensordash_matmul_fused")
    tensordash_matmul_fused.launches += 1
    return out, mask


tensordash_matmul_planned.launches = 0
tensordash_matmul_fused.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {
        "tensordash_matmul_planned": tensordash_matmul_planned.launches,
        "tensordash_matmul_fused": tensordash_matmul_fused.launches,
    }


def reset_launch_counts() -> None:
    tensordash_matmul_planned.launches = 0
    tensordash_matmul_fused.launches = 0
