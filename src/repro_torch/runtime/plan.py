"""Block-sparsity plans and a keyed plan cache (port of the single-device
part of ``repro/runtime/plan.py``).

A :class:`SparsityPlan` carries the compacted schedule ``(nnz, idx)`` of one
2-D operand, its CSR work queue, its block geometry and the operand's
shape/dtype.  :class:`PlanCache` replays a plan computed once (the LM head's
weight plan at the first prefill) on every later call; a hit requires the
queried operand to *be* the cached source tensor, so a replay is exact.
Sharding the plan waits for the distributed slice (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.tensordash_spmm import (
    _check_compact_grid,
    dense_plan_csr,
    plan_blocks_csr,
    plan_from_mask_csr,
    plan_workqueue,
)

__all__ = [
    "SparsityPlan",
    "PlanCache",
    "plan_operand",
    "plan_from_emitted_mask",
    "dense_operand_plan",
]


def _fit_block(block: int, dim: int) -> int:
    """Largest divisor of ``dim`` that is <= ``block`` (always >= 1)."""
    b = max(1, min(block, dim))
    while dim % b:
        b -= 1
    return b


@dataclasses.dataclass(frozen=True)
class SparsityPlan:
    """Compacted effectual-block schedule for one 2-D operand.

    ``idx[r, :nnz[r]]`` lists (ascending) the effectual K blocks of block
    row ``r``; ``row_starts``/``work_row``/``work_kblk`` are the same
    schedule as a CSR work queue.  ``side="B"`` plans the transposed right
    operand ``b.T [N, K]`` (weight sparsity).
    """

    nnz: Any  # [Rb] int32
    idx: Any  # [Rb, Kb] int32
    bm: int
    bk: int
    shape: tuple[int, int]  # shape of the planned operand (post-transpose for B)
    dtype: Any
    side: str = "A"
    row_starts: Any = None
    work_row: Any = None
    work_kblk: Any = None
    #: host-side stat cache, filled on first use (one device-to-host copy)
    _host: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.bm

    @property
    def k_blocks(self) -> int:
        return self.shape[1] // self.bk

    @property
    def total_blocks(self) -> int:
        return self.block_rows * self.k_blocks

    def workqueue(self):
        """``(row_starts, work_row, work_kblk)``, derived and memoized when
        the plan was built without it."""
        if self.row_starts is None:
            rs, wr, wk = plan_workqueue(torch.as_tensor(self.nnz), torch.as_tensor(self.idx))
            object.__setattr__(self, "row_starts", rs)
            object.__setattr__(self, "work_row", wr)
            object.__setattr__(self, "work_kblk", wk)
        return self.row_starts, self.work_row, self.work_kblk

    def host_nnz(self):
        """``nnz`` as a cached host-side tensor (copied once)."""
        if "nnz" not in self._host:
            self._host["nnz"] = torch.as_tensor(self.nnz).cpu()
        return self._host["nnz"]

    def effectual_blocks(self) -> int:
        return int(self.host_nnz().sum())

    def total_work(self) -> int:
        """Ragged-grid work items: ``sum(max(nnz, 1))``."""
        return int(torch.clamp_min(self.host_nnz(), 1).sum())

    def max_nnz(self) -> int:
        """The v2 grid's per-row K bound, ``max(nnz, 1)``."""
        nnz = self.host_nnz()
        return max(int(nnz.max()) if nnz.numel() else 0, 1)

    def grid_steps(self, nb: int, *, compact_grid="ragged") -> int:
        """Grid steps the planned kernel issues against ``nb`` output-column
        blocks (the TPU grid's count; see ``planned_grid_steps``), from the
        cached host-side stats: one copy of ``nnz`` at the first query."""
        compact_grid = _check_compact_grid(compact_grid)
        if compact_grid == "ragged":
            return nb * self.total_work()
        kdim = self.max_nnz() if compact_grid == "v2" else self.k_blocks
        return self.block_rows * nb * kdim

    def density(self) -> float:
        return self.effectual_blocks() / max(self.total_blocks, 1)

    def skipped_fraction(self) -> float:
        return 1.0 - self.density()

    def stats(self) -> dict:
        return {
            "shape": self.shape,
            "block": (self.bm, self.bk),
            "side": self.side,
            "blocks": self.total_blocks,
            "effectual": self.effectual_blocks(),
            "total_work": self.total_work(),
            "density": self.density(),
        }


def plan_operand(a: torch.Tensor, bm: int, bk: int, *, side: str = "A") -> SparsityPlan:
    """Plan a 2-D operand (already transposed for ``side="B"``)."""
    m, k = a.shape
    if m % bm or k % bk:
        raise ValueError(f"operand {tuple(a.shape)} not divisible by block ({bm}, {bk})")
    nnz, idx, row_starts, work_row, work_kblk = plan_blocks_csr(a, bm, bk)
    return SparsityPlan(
        nnz=nnz, idx=idx, bm=bm, bk=bk, shape=(m, k), dtype=a.dtype, side=side,
        row_starts=row_starts, work_row=work_row, work_kblk=work_kblk,
    )


def plan_from_emitted_mask(mask, shape, dtype, *, bm: int, mask_bn: int,
                           bk: int | None = None) -> SparsityPlan:
    """The consumer's plan from a producer-emitted ``int8 [M/bm, N/mask_bn]``
    output mask, metadata only.  When ``bk`` is a multiple of ``mask_bn``
    (and divides ``N``) adjacent mask columns are coarsened; otherwise the
    plan keeps the emitted ``mask_bn`` granularity."""
    coarsen = 1
    plan_bk = mask_bn
    if bk is not None and bk != mask_bn:
        if bk % mask_bn == 0 and shape[1] % bk == 0:
            coarsen, plan_bk = bk // mask_bn, bk
    nnz, idx, row_starts, work_row, work_kblk = plan_from_mask_csr(mask, coarsen=coarsen)
    return SparsityPlan(
        nnz=nnz, idx=idx, bm=bm, bk=plan_bk, shape=tuple(shape), dtype=dtype,
        row_starts=row_starts, work_row=work_row, work_kblk=work_kblk,
    )


def dense_operand_plan(shape, dtype, *, bm: int, bk: int, side: str = "A",
                       device="cpu") -> SparsityPlan:
    """The all-effectual plan of a known-dense operand: metadata only, from
    the per-``(mb, kb, device)`` memo of :func:`dense_plan_csr`."""
    m, k = shape
    if m % bm or k % bk:
        raise ValueError(f"operand {tuple(shape)} not divisible by block ({bm}, {bk})")
    nnz, idx, row_starts, work_row, work_kblk = dense_plan_csr(m // bm, k // bk, torch.device(device))
    return SparsityPlan(
        nnz=nnz, idx=idx, bm=bm, bk=bk, shape=(m, k), dtype=dtype, side=side,
        row_starts=row_starts, work_row=work_row, work_kblk=work_kblk,
    )


class PlanCache:
    """Keyed SparsityPlan cache with identity-validated hits, LRU eviction.

    Entries are keyed by ``(key, side, shape, dtype, bm, bk)`` and keep the
    source operand beside the plan.  A lookup hits only when the stored
    source *is* the queried tensor, so pass the same ``Parameter`` object on
    every call (a fresh ``.data``, ``.T`` or ``.to()`` view misses).
    """

    def __init__(self, capacity: int | None = None):
        self._entries: dict[tuple, tuple[Any, SparsityPlan]] = {}
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def _key(self, key, a, bm: int, bk: int, side: str) -> tuple:
        return (key, side, tuple(a.shape), str(a.dtype), bm, bk)

    def lookup(self, key, a, bm: int, bk: int, side: str = "A") -> SparsityPlan | None:
        k = self._key(key, a, bm, bk, side)
        entry = self._entries.get(k)
        if entry is not None and entry[0] is a:
            self.hits += 1
            self._entries[k] = self._entries.pop(k)  # LRU: move to the back
            return entry[1]
        return None

    def store(self, key, a, plan: SparsityPlan) -> SparsityPlan:
        self.misses += 1
        k = self._key(key, a, plan.bm, plan.bk, plan.side)
        if k in self._entries:
            self._entries.pop(k)
        elif self.capacity is not None and len(self._entries) >= self.capacity:
            self._entries.pop(next(iter(self._entries)))  # evict the coldest
        self._entries[k] = (a, plan)
        return plan

    def get_or_build(self, key, a, bm: int, bk: int, *, side: str = "A") -> SparsityPlan:
        plan = self.lookup(key, a, bm, bk, side)
        if plan is not None:
            return plan
        operand = a.T if side == "B" else a
        return self.store(key, a, plan_operand(operand, bm, bk, side=side))

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}

    def plan_stats(self) -> list[dict]:
        """Per-plan work summary for every live entry, coldest first."""
        return [
            {
                "key": key,
                "side": side,
                "shape": plan.shape,
                "block": (plan.bm, plan.bk),
                "blocks": plan.total_blocks,
                "total_work": plan.total_work(),
                "skipped_fraction": plan.skipped_fraction(),
            }
            for (key, side, *_rest), (_, plan) in self._entries.items()
        ]
