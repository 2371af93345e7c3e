"""Incremental CSR plan edits: prune/regrow deltas spliced into live plans
(port of ``repro/sparse_train/plan_edit.py``).

Dynamic sparse training (RigL-style, see
:mod:`repro_torch.sparse_train.controller`) changes a handful of mask
blocks every few hundred steps.  Rebuilding each layer's
:class:`~repro_torch.runtime.plan.SparsityPlan` from scratch prices every
refresh at a full pass over the weight.  But a prune/regrow step is a
*sparse* edit of the block mask: only the touched rows' compacted index
lists change, and every untouched row's work-queue segment merely shifts by
a constant offset.  This module applies the delta host-side in numpy, in
time proportional to the work displaced (small deltas splice contiguous gap
segments wholesale; dense deltas merge the prune/regrow keys into the sorted
effectual-entry stream — O(entries), never an O(Rb*Kb) mask scan), and
returns plans **bit-identical** to a from-scratch replan of the edited mask
(the planner's ``emitted`` mode on the card, ``plan_blocks_csr`` of an
operand with that block map anywhere).

The numpy work is the JAX package's, line for line.  What differs is where
the result lives: the port's kernels read plan metadata from device
tensors, so an edited plan holds its five int32 arrays on the device of the
plan it edits (one host-to-device copy each) and keeps the host arrays
beside them (``SparsityPlan._host``), so the next edit and the plan's
statistics read no device memory.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.plan import SparsityPlan
from repro_torch.runtime.runtime import resolve

__all__ = ["PlanDelta", "apply_delta", "edit_plan", "plan_from_block_mask"]

#: affected-row fraction above which the splice degenerates (nearly every
#: gap segment is empty) and one vectorized rebuild is cheaper
_SPLICE_MAX_ROW_FRACTION = 0.125


@dataclasses.dataclass(frozen=True)
class PlanDelta:
    """One prune/regrow step as ``(row, kblk)`` block coordinates.

    Coordinates are in the *planned operand's* orientation: ``prune[i] =
    (r, k)`` deactivates block ``(r, k)`` of the plan's ``[Rb, Kb]`` block
    mask, ``regrow`` activates.  A weight matmul keeps two plans — the
    forward ``side="B"`` plan over ``w.T`` and the transposed backward plan
    over ``w`` — whose masks are transposes of each other, so one delta
    serves both: apply it to one plan and :meth:`swapped` to the other.
    """

    prune: np.ndarray  # [P, 2] int32
    regrow: np.ndarray  # [R, 2] int32

    @staticmethod
    def make(prune, regrow) -> "PlanDelta":
        return PlanDelta(
            prune=np.asarray(prune, np.int32).reshape(-1, 2),
            regrow=np.asarray(regrow, np.int32).reshape(-1, 2),
        )

    def swapped(self) -> "PlanDelta":
        """The same edit in the transposed orientation (``(r, k) -> (k, r)``)."""
        return PlanDelta(prune=self.prune[:, ::-1], regrow=self.regrow[:, ::-1])

    @property
    def size(self) -> int:
        return len(self.prune) + len(self.regrow)


def _mask_to_plan_np(mask: np.ndarray):
    """Numpy twin of ``tensordash_spmm._mask_to_plan``: identical slot
    assignment (ascending effectual order), identical tail convention
    (repeat the last effectual index; all-zero rows stay all-zero) —
    integer ops only, so the outputs are bit-identical to the jitted
    device path.  Works on the effectual entries (``np.nonzero`` is
    row-major, so the compacted slot is just the entry's rank within its
    row) instead of a full-grid cumsum — the edit path's cost scales with
    effectual blocks, not the mask footprint.
    """
    mb, kb = mask.shape
    mask = mask != 0
    nnz = mask.sum(axis=1, dtype=np.int64)
    rows, ks = np.nonzero(mask)
    starts = np.zeros((mb + 1,), np.int64)
    np.cumsum(nnz, out=starts[1:])
    slot = np.arange(len(rows), dtype=np.int64) - starts[rows]
    idx = np.zeros((mb, kb), np.int32)
    idx[rows, slot] = ks
    last = idx[np.arange(mb), np.maximum(nnz - 1, 0)]
    tail = np.arange(kb, dtype=np.int64)[None, :] >= np.maximum(nnz, 1)[:, None]
    idx[tail] = np.broadcast_to(last[:, None], (mb, kb))[tail]
    return nnz.astype(np.int32), idx


def _workqueue_np(nnz: np.ndarray, idx: np.ndarray):
    """Numpy twin of ``tensordash_spmm.plan_workqueue``: same flat ``Mb*Kb``
    footprint, same zeroed tail past ``row_starts[-1]``.  The queue is the
    effectual entries in row-major order (one placeholder per all-zero
    row), so it is built by one gather over ``total_work`` entries."""
    mb, kb = idx.shape
    work = np.maximum(nnz, 1).astype(np.int32)
    row_starts = np.zeros((mb + 1,), np.int32)
    np.cumsum(work, out=row_starts[1:])
    total = int(row_starts[-1])
    work_row = np.zeros((mb * kb,), np.int32)
    work_kblk = np.zeros((mb * kb,), np.int32)
    wr = np.repeat(np.arange(mb, dtype=np.int32), work)
    j = np.arange(total, dtype=np.int64) - row_starts[wr]
    work_row[:total] = wr
    work_kblk[:total] = idx[wr, j]
    return row_starts, work_row, work_kblk


def _host_arrays(plan: SparsityPlan):
    """``(nnz, idx, row_starts, work_row, work_kblk)`` as host int32 arrays:
    the copies an edited plan keeps, or one device-to-host copy each."""
    arrays = plan._host.get("arrays")
    if arrays is None:
        # lint: allow-host-sync: plan edits run on the host, one copy per array, cached
        arrays = tuple(torch.as_tensor(x).cpu().numpy()
                       for x in (plan.nnz, plan.idx, *plan.workqueue()))
    return arrays


def _device_of(plan: SparsityPlan) -> torch.device:
    return torch.as_tensor(plan.idx).device


def _make_plan(nnz, idx, row_starts, work_row, work_kblk, *, bm: int, bk: int,
               shape, dtype, side: str, device) -> SparsityPlan:
    """A plan whose metadata is on ``device``, with the host arrays kept
    beside it (``_host["arrays"]``, and ``_host["nnz"]`` for the plan's
    statistics)."""
    arrays = tuple(np.ascontiguousarray(x, dtype=np.int32)
                   for x in (nnz, idx, row_starts, work_row, work_kblk))
    on = [torch.from_numpy(x).to(device) for x in arrays]
    return SparsityPlan(
        nnz=on[0], idx=on[1], bm=bm, bk=bk, shape=tuple(shape), dtype=dtype, side=side,
        row_starts=on[2], work_row=on[3], work_kblk=on[4],
        _host={"arrays": arrays, "nnz": torch.from_numpy(arrays[0])},
    )


def plan_from_block_mask(mask, *, bm: int, bk: int, shape, dtype,
                         side: str = "A", device="cpu") -> SparsityPlan:
    """A :class:`SparsityPlan` from an explicit ``[Rb, Kb]`` block mask —
    built on the host in numpy, its metadata then placed on ``device``.
    Bit-identical to ``plan_blocks_csr`` of an operand whose block-nonzero
    map is ``mask``."""
    mask = np.asarray(mask)
    nnz, idx = _mask_to_plan_np(mask)
    row_starts, work_row, work_kblk = _workqueue_np(nnz, idx)
    return _make_plan(nnz, idx, row_starts, work_row, work_kblk, bm=bm, bk=bk,
                      shape=shape, dtype=dtype, side=side, device=device)


def apply_delta(mask: np.ndarray, delta: PlanDelta) -> np.ndarray:
    """The edited block mask, with loud validation.

    A prune of an already-inactive block or a regrow of an already-active
    one means the controller's view of the mask has drifted from the plan's
    — silently absorbing it would let the two diverge, so raise instead.
    """
    mask = np.asarray(mask).astype(bool)
    out = mask.copy()
    if len(delta.prune):
        r, k = delta.prune[:, 0], delta.prune[:, 1]
        if not mask[r, k].all():
            bad = delta.prune[~mask[r, k]]
            raise ValueError(f"prune of inactive block(s) {bad.tolist()[:4]}")
        out[r, k] = False
    if len(delta.regrow):
        r, k = delta.regrow[:, 0], delta.regrow[:, 1]
        if mask[r, k].any():
            bad = delta.regrow[mask[r, k]]
            raise ValueError(f"regrow of active block(s) {bad.tolist()[:4]}")
        if len(delta.prune) and len(
            np.intersect1d(
                delta.prune[:, 0].astype(np.int64) * mask.shape[1] + delta.prune[:, 1],
                delta.regrow[:, 0].astype(np.int64) * mask.shape[1] + delta.regrow[:, 1],
            )
        ):
            raise ValueError("delta prunes and regrows the same block")
        out[r, k] = True
    return out


def _edit_entries(plan: SparsityPlan, delta: PlanDelta) -> SparsityPlan:
    """Delta-driven rebuild for dense deltas: merge the prune/regrow keys
    into the plan's existing (row-major sorted) effectual-entry stream and
    regenerate ``idx`` + queue from the merged stream — a handful of O(E)
    passes over the effectual entries, never an O(Rb*Kb) mask scan.

    The old work queue *is* the sorted entry stream (one placeholder per
    all-zero row aside), so deletions are a ``searchsorted`` + mask and
    insertions one ``np.insert`` — and the membership checks the merge does
    anyway double as the :func:`apply_delta` validation.
    """
    nnz, idx, row_starts, work_row, work_kblk = _host_arrays(plan)
    mb, kb = idx.shape
    total = int(row_starts[-1])
    wr, wk = work_row[:total], work_kblk[:total]
    real = nnz[wr] > 0  # drop all-zero rows' gated placeholders
    keys = wr[real].astype(np.int64) * kb + wk[real]

    def _keyset(pairs, what):
        ks = pairs[:, 0].astype(np.int64) * kb + pairs[:, 1]
        ks = np.sort(ks)
        if len(ks) > 1 and (ks[1:] == ks[:-1]).any():
            raise ValueError(f"duplicate {what} blocks in delta")
        return ks

    prune_keys = _keyset(delta.prune, "prune") if len(delta.prune) else np.empty(0, np.int64)
    regrow_keys = _keyset(delta.regrow, "regrow") if len(delta.regrow) else np.empty(0, np.int64)
    if len(prune_keys) and len(regrow_keys) and len(np.intersect1d(prune_keys, regrow_keys)):
        raise ValueError("delta prunes and regrows the same block")
    if len(prune_keys):
        pos = np.searchsorted(keys, prune_keys)
        ok = (pos < len(keys)) & (
            keys[np.minimum(pos, max(len(keys) - 1, 0))] == prune_keys
            if len(keys) else False
        )
        if not np.asarray(ok).all():
            bad = np.stack([prune_keys[~ok] // kb, prune_keys[~ok] % kb], 1)
            raise ValueError(f"prune of inactive block(s) {bad.tolist()[:4]}")
        keep = np.ones(len(keys), bool)
        keep[pos] = False
        keys = keys[keep]
    if len(regrow_keys):
        pos = np.searchsorted(keys, regrow_keys)
        clash = (pos < len(keys)) & (
            keys[np.minimum(pos, max(len(keys) - 1, 0))] == regrow_keys
            if len(keys) else False
        )
        clash = np.asarray(clash)
        if clash.any():
            bad = np.stack([regrow_keys[clash] // kb, regrow_keys[clash] % kb], 1)
            raise ValueError(f"regrow of active block(s) {bad.tolist()[:4]}")
        keys = np.insert(keys, pos, regrow_keys)

    rows = (keys // kb).astype(np.int64)
    ks = (keys % kb).astype(np.int32)
    new_nnz = np.bincount(rows, minlength=mb).astype(np.int64)
    starts = np.zeros((mb + 1,), np.int64)
    np.cumsum(new_nnz, out=starts[1:])
    rank = np.arange(len(keys), dtype=np.int64) - starts[rows]
    new_idx = np.zeros((mb, kb), np.int32)
    new_idx[rows, rank] = ks
    last = new_idx[np.arange(mb), np.maximum(new_nnz - 1, 0)]
    tail = np.arange(kb, dtype=np.int64)[None, :] >= np.maximum(new_nnz, 1)[:, None]
    new_idx = np.where(tail, last[:, None], new_idx)
    work = np.maximum(new_nnz, 1).astype(np.int32)
    new_rs = np.zeros((mb + 1,), np.int32)
    np.cumsum(work, out=new_rs[1:])
    new_total = int(new_rs[-1])
    new_wr = np.zeros((mb * kb,), np.int32)
    new_wk = np.zeros((mb * kb,), np.int32)
    new_wr[:new_total] = np.repeat(np.arange(mb, dtype=np.int32), work)
    new_wk[(new_rs[rows] + rank).astype(np.int64)] = ks  # placeholders stay 0
    return _make_plan(
        new_nnz, new_idx, new_rs, new_wr, new_wk, bm=plan.bm, bk=plan.bk,
        shape=plan.shape, dtype=plan.dtype, side=plan.side, device=_device_of(plan),
    )


def _splice_workqueue(plan: SparsityPlan, new_nnz, new_idx, affected):
    """Segment splice: recompute only the affected rows' queue entries and
    bulk-copy every untouched row's contiguous segment at its shifted
    offset.  Work is O(rows touched + segments moved), not O(Rb * Kb)."""
    _, _, old_rs, old_wr, old_wk = _host_arrays(plan)
    mb, kb = new_idx.shape
    work = np.maximum(new_nnz, 1).astype(np.int32)
    row_starts = np.zeros((mb + 1,), np.int32)
    np.cumsum(work, out=row_starts[1:])
    work_row = np.zeros((mb * kb,), np.int32)
    work_kblk = np.zeros((mb * kb,), np.int32)

    # gap segments between consecutive affected rows shift by a constant
    # offset; copy them wholesale from the old queue (values unchanged)
    bounds = np.concatenate(([-1], affected, [mb]))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        src0, src1 = old_rs[lo + 1], old_rs[hi]
        if src1 > src0:
            dst0 = row_starts[lo + 1]
            work_row[dst0:dst0 + (src1 - src0)] = old_wr[src0:src1]
            work_kblk[dst0:dst0 + (src1 - src0)] = old_wk[src0:src1]
    # affected rows: fresh entries from the recomputed index lists
    for r in affected:
        w = int(work[r])
        s = int(row_starts[r])
        work_row[s:s + w] = r
        work_kblk[s:s + w] = new_idx[r, :w]
    return row_starts, work_row, work_kblk


def edit_plan(plan: SparsityPlan, delta: PlanDelta, *,
              validate: str | None = None) -> SparsityPlan:
    """Apply a prune/regrow delta to a live plan — the incremental
    replacement for a full replan.

    The plan's compaction is lossless (``idx[r, :nnz[r]]`` *is* the block
    mask row), so the edit needs no external mask: affected rows are
    re-compacted from their current index lists with the delta applied, and
    the flat work queue is spliced around them.  Returns a new plan with its
    metadata on the input plan's device, bit-identical to
    ``plan_blocks_csr`` of an operand with the edited block mask; the input
    plan is not mutated.

    Two validation layers, different failure classes: the delta-vs-plan
    *semantic* checks above (prune-inactive / regrow-active / overlap)
    always run — they catch controller/plan drift that no amount of plan
    self-consistency can see.  ``validate`` (``"boundary"`` or ``"full"``)
    additionally runs the shared *structural* verifier
    (:func:`repro_torch.analysis.plan_check.check_plan`) on the edited
    result, proving the spliced queue is still exactly the CSR schedule of
    the edited ``(nnz, idx)``.  ``None`` takes the ambient runtime's level
    (``Runtime.validate``).
    """
    if validate is None:
        validate = resolve().validate
    if delta.size == 0:
        return plan
    nnz, idx, *_ = _host_arrays(plan)
    mb, kb = idx.shape
    touched = np.concatenate([delta.prune[:, 0], delta.regrow[:, 0]])
    affected = np.unique(touched)
    if affected.size and (affected.min() < 0 or affected.max() >= mb):
        raise ValueError(f"delta row out of range for {mb} block rows")
    cols = np.concatenate([delta.prune[:, 1], delta.regrow[:, 1]])
    if cols.size and (cols.min() < 0 or cols.max() >= kb):
        raise ValueError(f"delta k-block out of range for {kb} K blocks")

    if affected.size > _SPLICE_MAX_ROW_FRACTION * mb:
        # dense delta: almost every gap segment between affected rows is
        # empty, so splicing degenerates — merge the delta into the sorted
        # effectual-entry stream instead (identical output either way)
        return _validated(_edit_entries(plan, delta), validate)

    # reconstruct the affected rows' mask, validate + apply the delta there
    sub = np.zeros((affected.size, kb), bool)
    local = {int(r): i for i, r in enumerate(affected)}
    valid = np.arange(kb, dtype=np.int32)[None, :] < nnz[affected][:, None]
    sub[np.nonzero(valid)[0], idx[affected][valid]] = True
    to_local = np.vectorize(local.__getitem__, otypes=[np.int64])
    sub_delta = PlanDelta(
        prune=np.stack([to_local(delta.prune[:, 0]), delta.prune[:, 1]], 1).astype(np.int32)
        if len(delta.prune) else delta.prune,
        regrow=np.stack([to_local(delta.regrow[:, 0]), delta.regrow[:, 1]], 1).astype(np.int32)
        if len(delta.regrow) else delta.regrow,
    )
    sub = apply_delta(sub, sub_delta)
    sub_nnz, sub_idx = _mask_to_plan_np(sub)

    new_nnz = nnz.copy()
    new_nnz[affected] = sub_nnz
    new_idx = idx.copy()
    new_idx[affected] = sub_idx

    row_starts, work_row, work_kblk = _splice_workqueue(
        plan, new_nnz, new_idx, affected
    )
    return _validated(_make_plan(
        new_nnz, new_idx, row_starts, work_row, work_kblk, bm=plan.bm, bk=plan.bk,
        shape=plan.shape, dtype=plan.dtype, side=plan.side, device=_device_of(plan),
    ), validate)


def _validated(plan: SparsityPlan, level: str) -> SparsityPlan:
    if level != "off":
        from repro_torch.analysis.plan_check import check_plan  # local: keep import light

        check_plan(plan, level=level)
    return plan
