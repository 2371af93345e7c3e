"""Block-sparsity plans, their per-shard split and a keyed plan cache (port
of ``repro/runtime/plan.py``).

A :class:`SparsityPlan` carries the compacted schedule ``(nnz, idx)`` of one
2-D operand, its CSR work queue, its block geometry and the operand's
shape/dtype.  :class:`PlanCache` replays a plan computed once (the LM head's
weight plan at the first prefill) on every later call; a hit requires the
queried operand to *be* the cached source tensor, unmodified since (its
``_version``), so a replay is exact.

``PlanCache(validate=...)`` (normally set by ``Runtime(validate=...)``)
verifies every plan it stores (:mod:`repro_torch.analysis.plan_check`), and
:meth:`PlanCache.scrub` re-verifies the live entries and evicts the corrupt
ones.  Verification copies plan metadata to the host, so it is skipped while
the current CUDA stream captures a graph (:func:`capturing`), as the JAX
package skips traced plans; it runs at the eager warm-up instead.

:func:`shard_plan` splits a plan into per-shard ragged work queues along M,
N or K (host-side numpy, as in the JAX package), :func:`unshard_plan`
inverts it, and :func:`balanced_row_order` is the serpentine deal of block
rows by descending work that the M-sharded executors of
:mod:`repro_torch.parallel.spmm` use on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
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
    "PlanShards",
    "PlanCache",
    "plan_operand",
    "plan_from_emitted_mask",
    "dense_operand_plan",
    "balanced_row_order",
    "shard_plan",
    "unshard_plan",
    "capturing",
]


def capturing() -> bool:
    """True while the current CUDA stream captures a graph: then nothing may
    read the device from the host, and plan verification is skipped.  A
    build of torch without CUDA never captures."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:  # torch built without CUDA
        return False


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
            # lint: allow-host-sync: the one cached copy behind every host-side count
            self._host["nnz"] = torch.as_tensor(self.nnz).cpu()
        return self._host["nnz"]

    def effectual_blocks(self) -> int:
        return int(self.host_nnz().sum())

    def total_work(self) -> int:
        """Ragged-grid work items: ``sum(max(nnz, 1))``."""
        return int(torch.clamp_min(self.host_nnz(), 1).sum())  # lint: allow-host-sync: a host copy

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

    def shard(self, n_shards: int, *, axis: str = "M", balance: bool = True) -> "PlanShards":
        """This plan split into ``n_shards`` per-shard work queues
        (:func:`shard_plan`), memoized host-side per ``(n_shards, axis,
        balance)``."""
        key = ("shards", n_shards, axis, balance)
        if key not in self._host:
            self._host[key] = shard_plan(self, n_shards, axis=axis, balance=balance)
        return self._host[key]


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


# ---------------------------------------------------------------------------
# plan sharding: per-shard ragged work queues
# ---------------------------------------------------------------------------


def balanced_row_order(nnz, n_shards: int):
    """Serpentine-balanced block-row order for an M-sharded plan.

    Rows sorted by descending work (``max(nnz, 1)``, ties in row order) are
    dealt boustrophedon across ``n_shards``: shard ``s`` takes position
    ``s`` on even rounds and ``n_shards-1-s`` on odd ones, so every shard
    gets ``Rb / n_shards`` rows with near-equal total work.  Returns the
    ``[Rb] int32`` order, shard-major (shard ``s`` owns
    ``order[s*r:(s+1)*r]``), as a numpy array for numpy ``nnz`` and as a
    tensor on ``nnz``'s device otherwise: the host-side split and the
    executors' in-place deal are the same assignment.  Reordering block rows
    moves each row's schedule with it, so execution stays bitwise.
    """
    host = isinstance(nnz, np.ndarray)
    nnz = torch.as_tensor(nnz)
    (rb,) = nnz.shape
    if rb % n_shards:
        raise ValueError(f"{rb} block rows not divisible by {n_shards} shards")
    work = torch.clamp_min(nnz.to(torch.int32), 1)
    by_work = torch.argsort(-work, stable=True).to(torch.int32)
    rounds = rb // n_shards
    s = torch.arange(n_shards, device=nnz.device)[:, None]
    r = torch.arange(rounds, device=nnz.device)[None, :]
    pos = r * n_shards + torch.where(r % 2 == 0, s, n_shards - 1 - s)
    order = by_work[pos.reshape(-1)]
    return order.cpu().numpy() if host else order  # lint: allow-host-sync: host=True asks for it


@dataclasses.dataclass(frozen=True)
class PlanShards:
    """A :class:`SparsityPlan` split into per-shard ragged work queues.

    ``nnz``/``idx``/``row_starts``/``work_row``/``work_kblk`` are host numpy
    int32 arrays with a leading shard dim.  Per axis:

    * ``"M"``: block rows are dealt to shards by ``order`` (serpentine when
      ``balance``, else contiguous); shard ``s`` owns rows
      ``order[s*r:(s+1)*r]`` with their global K indices;
    * ``"N"``: the schedule is replicated, every shard walks the full queue
      against its own output columns;
    * ``"K"``: each shard replans its K-block slice (indices local to it)
      from the expanded block mask.
    """

    plan: SparsityPlan
    axis: str
    n_shards: int
    order: Any  # [Rb] int32 block-row assignment (shard-major; M only)
    nnz: Any  # [S, rows]
    idx: Any  # [S, rows, Kb_local]
    row_starts: Any  # [S, rows+1]
    work_row: Any  # [S, rows*Kb_local]
    work_kblk: Any

    def shard_work(self) -> np.ndarray:
        """Per-shard ragged-grid steps per N block: ``sum(max(nnz, 1))``."""
        return np.maximum(np.asarray(self.nnz), 1).sum(axis=1)

    def imbalance(self) -> float:
        """Max over mean of :meth:`shard_work` (1.0 is a perfect balance)."""
        w = self.shard_work()
        return float(w.max() / w.mean())

    def stats(self) -> dict:
        w = self.shard_work()
        return {
            "axis": self.axis,
            "n_shards": self.n_shards,
            "shard_work": [int(x) for x in w],
            "imbalance": self.imbalance(),
            "total_work": int(w.sum()),
        }


def _plan_block_mask_np(nnz: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Expand compacted ``(nnz, idx)`` back to the bool ``[Rb, Kb]`` block
    mask (the tail's repeated indices are excluded by the ``nnz`` bound)."""
    rb, kb = idx.shape
    valid = np.arange(kb, dtype=np.int64)[None, :] < nnz[:, None]
    rows = np.broadcast_to(np.arange(rb, dtype=np.int64)[:, None], idx.shape)
    mask = np.zeros((rb, kb), bool)
    mask[rows[valid], idx[valid]] = True
    return mask


def _host_plan(plan: SparsityPlan):
    """``(nnz, idx)`` of ``plan`` as host int32 arrays."""
    nnz = plan.host_nnz().numpy().astype(np.int32)
    # lint: allow-host-sync allow-np-on-device: shard_plan works on the host, as JAX's does
    idx = np.asarray(torch.as_tensor(plan.idx).cpu(), dtype=np.int32)
    return nnz, idx


def shard_plan(plan: SparsityPlan, n_shards: int, *, axis: str = "M",
               balance: bool = True) -> PlanShards:
    """Split ``plan`` into ``n_shards`` per-shard work queues, host-side.

    Each shard's CSR queue is rebuilt from its own rows or columns, so
    ``row_starts[s][-1]`` is exactly that shard's ragged-grid steps per N
    block.  ``balance`` (M axis) deals rows serpentine by descending work
    (:func:`balanced_row_order`); ``False`` keeps the contiguous split, the
    imbalance baseline."""
    from repro_torch.sparse_train.plan_edit import _mask_to_plan_np, _workqueue_np  # local: import cycle

    if axis not in ("M", "N", "K"):
        raise ValueError(f"shard axis {axis!r} not in ('M', 'N', 'K')")
    nnz, idx = _host_plan(plan)
    rb, kb = idx.shape
    order = np.arange(rb, dtype=np.int32)
    if axis == "M":
        if rb % n_shards:
            raise ValueError(f"{rb} block rows not divisible by {n_shards} shards")
        if balance:
            order = balanced_row_order(nnz, n_shards)
        rows = rb // n_shards
        nnz_s = nnz[order].reshape(n_shards, rows)
        idx_s = idx[order].reshape(n_shards, rows, kb)
    elif axis == "N":
        nnz_s = np.broadcast_to(nnz, (n_shards, rb)).copy()
        idx_s = np.broadcast_to(idx, (n_shards, rb, kb)).copy()
    else:
        if kb % n_shards:
            raise ValueError(f"{kb} K blocks not divisible by {n_shards} shards")
        kbl = kb // n_shards
        mask = _plan_block_mask_np(nnz, idx)
        parts = [_mask_to_plan_np(mask[:, s * kbl:(s + 1) * kbl]) for s in range(n_shards)]
        nnz_s = np.stack([p[0] for p in parts])
        idx_s = np.stack([p[1] for p in parts])
    queues = [_workqueue_np(nnz_s[s], idx_s[s]) for s in range(n_shards)]
    return PlanShards(
        plan=plan, axis=axis, n_shards=n_shards, order=order, nnz=nnz_s, idx=idx_s,
        row_starts=np.stack([q[0] for q in queues]),
        work_row=np.stack([q[1] for q in queues]),
        work_kblk=np.stack([q[2] for q in queues]),
    )


def unshard_plan(shards: PlanShards) -> SparsityPlan:
    """Reassemble the global plan from its shards, the exact inverse of
    :func:`shard_plan`; the queue is rebuilt from the merged schedule.  The
    plan's metadata lies on the device of the plan that was split."""
    from repro_torch.sparse_train.plan_edit import (  # local: import cycle
        _device_of, _make_plan, _mask_to_plan_np, _workqueue_np,
    )

    src = shards.plan
    if shards.axis == "N":
        nnz, idx = np.asarray(shards.nnz[0]), np.asarray(shards.idx[0])
    elif shards.axis == "M":
        rb = shards.order.shape[0]
        kb = shards.idx.shape[-1]
        nnz = np.empty((rb,), np.int32)
        idx = np.empty((rb, kb), np.int32)
        nnz[shards.order] = shards.nnz.reshape(rb)
        idx[shards.order] = shards.idx.reshape(rb, kb)
    else:
        s_, rb, kbl = shards.idx.shape
        mask = np.zeros((rb, s_ * kbl), bool)
        for s in range(s_):
            mask[:, s * kbl:(s + 1) * kbl] = _plan_block_mask_np(
                np.asarray(shards.nnz[s]), np.asarray(shards.idx[s]))
        nnz, idx = _mask_to_plan_np(mask)
    return _make_plan(nnz, idx, *_workqueue_np(nnz, idx), bm=src.bm, bk=src.bk, shape=src.shape,
                      dtype=src.dtype, side=src.side, device=_device_of(src))


def _version(a) -> int | None:
    """``a``'s in-place version counter (``None`` for an inference tensor,
    which keeps none: such a source is validated by identity alone)."""
    return None if a.is_inference() else a._version


class PlanCache:
    """Keyed SparsityPlan cache with identity- and version-validated hits,
    LRU eviction.

    Entries are keyed by ``(key, side, shape, dtype, bm, bk)`` and keep the
    source operand and its version counter beside the plan.  A lookup hits
    only when the stored source *is* the queried tensor and has not been
    modified in place since (an optimizer step on a weight bumps its
    ``_version``): pass the same tensor object on every call (a fresh
    ``.data``, ``.T`` or ``.to()`` view misses).  A miss under a live key
    replaces its entry, so a weight updated in place is replanned under the
    same key and the stale plan is dropped.

    ``validate`` (normally propagated from ``Runtime(validate=...)``) gates
    the static verifier at every insertion: ``"boundary"`` runs the O(Rb)
    structural checks, ``"full"`` the O(entries) content checks.  Hits are
    never re-verified; :meth:`scrub` re-verifies the live entries.
    """

    def __init__(self, capacity: int | None = None, validate: str = "off"):
        self._entries: dict[tuple, tuple[Any, int | None, SparsityPlan]] = {}
        self.capacity = capacity
        self.validate = validate
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _key(self, key, a, bm: int, bk: int, side: str) -> tuple:
        return (key, side, tuple(a.shape), str(a.dtype), bm, bk)

    def lookup(self, key, a, bm: int, bk: int, side: str = "A") -> SparsityPlan | None:
        k = self._key(key, a, bm, bk, side)
        entry = self._entries.get(k)
        if entry is not None and entry[0] is a and entry[1] == _version(a):
            self.hits += 1
            self._entries[k] = self._entries.pop(k)  # LRU: move to the back
            return entry[2]
        return None

    def store(self, key, a, plan: SparsityPlan) -> SparsityPlan:
        self.misses += 1
        if self.validate != "off" and not capturing():
            from repro_torch.analysis.plan_check import check_plan  # local: keep import light

            check_plan(plan, level=self.validate)
        k = self._key(key, a, plan.bm, plan.bk, plan.side)
        if k in self._entries:
            self._entries.pop(k)
        elif self.capacity is not None and len(self._entries) >= self.capacity:
            self._entries.pop(next(iter(self._entries)))  # evict the coldest
        self._entries[k] = (a, _version(a), plan)
        return plan

    def get_or_build(self, key, a, bm: int, bk: int, *, side: str = "A") -> SparsityPlan:
        """The cached plan of ``a`` under ``key``, built and stored on a
        miss.  A plan is built outside inference mode, so a plan a serve
        call cached can be saved for a later training step's backward."""
        plan = self.lookup(key, a, bm, bk, side)
        if plan is not None:
            return plan
        operand = a.T if side == "B" else a
        with torch.inference_mode(False):
            plan = plan_operand(operand, bm, bk, side=side)
        return self.store(key, a, plan)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}

    def plan_stats(self, shards: int | None = None) -> list[dict]:
        """Per-plan work summary for every live entry, coldest first.

        With ``shards`` (a device count), every plan whose block rows divide
        it also reports its M-sharded split under the serpentine deal:
        per-shard ``total_work`` (``shard_work``), the per-shard skipped
        fractions and ``imbalance`` (max over mean).  A plan whose rows do
        not divide reports its global figures only, as the executors run it
        unsharded."""
        out = []
        for (key, side, *_rest), (_, _, plan) in self._entries.items():
            entry = {
                "key": key,
                "side": side,
                "shape": plan.shape,
                "block": (plan.bm, plan.bk),
                "blocks": plan.total_blocks,
                "total_work": plan.total_work(),
                "skipped_fraction": plan.skipped_fraction(),
            }
            if shards and shards > 1 and plan.block_rows % shards == 0:
                ps = plan.shard(shards)
                blocks_per_shard = plan.total_blocks / shards
                entry["shard_work"] = [int(w) for w in ps.shard_work()]
                entry["shard_skipped"] = [1.0 - float(n.sum()) / blocks_per_shard for n in ps.nnz]
                entry["imbalance"] = ps.imbalance()
            out.append(entry)
        return out

    def scrub(self, *, level: str | None = None) -> list[tuple]:
        """Re-verify every live entry and evict the corrupt ones.

        Store-time validation proves an entry was good when it went in;
        ``scrub`` is for when something mutated it afterwards (a fault
        injector here; a bad in-place edit in the wild).  Returns ``[(key,
        error), ...]`` for the evicted entries; an evicted plan is rebuilt
        from its operand at the next miss.  ``level`` defaults to ``"full"``:
        a scrub is an explicit sweep, so it pays for the content checks
        that catch what the boundary tier cannot."""
        from repro_torch.analysis.plan_check import (  # local: keep import light
            PlanVerificationError,
            check_plan,
        )

        level = level or "full"
        bad = []
        for k, (_, _, plan) in list(self._entries.items()):
            try:
                check_plan(plan, level=level)
            except PlanVerificationError as e:
                bad.append((k, str(e)))
                del self._entries[k]
        return bad
