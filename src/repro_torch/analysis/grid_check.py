"""Abstract interpretation of the CUDA kernels' grids (port of
``repro/analysis/grid_check.py`` for ``csrc/tensordash_spmm.cu``).

The kernels are correct only if their grid and the plan compose into a
valid schedule: every block access in bounds, every effectual block
accumulated exactly once, every output tile stored.  This module re-enacts
the CUDA grid ``(N/TN, Mb, S)`` in host numpy: CTA ``(n, m, s)`` takes
steps ``[s * per, (s + 1) * per)`` of block row ``m``'s effectual list,
``per = ceil(cnt / S)``, where ``cnt`` is the row's queue segment
``row_starts[m+1] - row_starts[m]`` (ragged) or ``nnz[m]`` (v1/v2), and a
row with ``nnz[m] == 0`` contracts nothing.  The column tiles multiply every
output tile alike and cannot change validity, so ``nb`` only has to be
positive.  The finding codes are the JAX package's:

* **ragged**: ``row_starts`` is a monotone ``[Mb+1]`` table inside the
  queue arrays (``grid.queue-shape``); the queue's ``work_row`` names the
  row whose segment holds each item (``grid.a-oob`` out of range,
  ``grid.zero-order`` in another row's segment); ``work_kblk`` stays in
  ``[0, Kb)`` (``grid.b-oob``); each row owns ``max(nnz, 1)`` items, one
  store per tile (``grid.store-count``); the blocks the CTAs accumulate are
  the plan's effectual set (``grid.work-dup``, ``grid.work-missing``).
* **v1/v2**: the K bound ``kdim`` (``Kb``, or ``max(max(nnz), 1)``) is at
  least 1 (``grid.store-count``: the kernels take no empty grid), at most
  ``Kb`` (``grid.a-oob``) and covers every row's ``nnz``
  (``grid.work-missing``: the CTAs stop at ``kdim``); every ``idx`` entry a
  CTA dereferences is in ``[0, Kb)`` (``grid.b-oob``); no block is
  accumulated twice (``grid.work-dup``).  The CUDA kernel reads ``idx`` only
  on effectual steps, so a corrupt tail past ``nnz`` is no grid defect here
  (``verify_plan`` reports it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.plan_check import Finding, _host

__all__ = ["check_grid", "check_plan_grid"]


def _shares(cnt: np.ndarray, splits: int):
    """Per row, the ``[beg, end)`` step range of each of the ``S`` CTAs:
    ``[Mb, S]`` arrays, exactly the kernel's ``min(cnt, s * per)``."""
    per = -(-cnt // splits)
    s = np.arange(splits, dtype=np.int64)[None, :]
    return np.minimum(cnt[:, None], s * per[:, None]), np.minimum(cnt[:, None], (s + 1) * per[:, None])


def _walk(nnz, cnt, bound, splits: int):
    """``(row, step)`` of every step a CTA accumulates: steps of the row's
    share below ``bound``, on rows with ``nnz > 0``."""
    beg, end = _shares(cnt, splits)
    end = np.minimum(end, bound[:, None])
    rows, steps = [], []
    for m in np.nonzero(nnz > 0)[0]:
        for b, e in zip(beg[m], end[m]):
            steps.append(np.arange(b, e, dtype=np.int64))
            rows.append(np.full(max(e - b, 0), m, np.int64))
    if not steps:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(rows), np.concatenate(steps)


def _coverage(got: np.ndarray, nnz, idx, where: tuple) -> list[Finding]:
    """Compare the accumulated ``row * Kb + kblk`` multiset with the plan's
    effectual set."""
    f: list[Finding] = []
    kb = idx.shape[1]
    valid = np.arange(kb, dtype=np.int64)[None, :] < nnz[:, None]
    rows = np.broadcast_to(np.arange(idx.shape[0], dtype=np.int64)[:, None], idx.shape)
    want = np.unique(rows[valid] * kb + idx[valid].astype(np.int64))
    got = np.sort(got)
    dup = got.size - np.unique(got).size
    extra = np.setdiff1d(got, want).size
    if dup or extra:
        f.append(Finding(
            "grid.work-dup",
            f"{max(dup, extra)} MAC(s) double-accumulated or not in the plan's effectual set",
            where,
        ))
    missing = np.setdiff1d(want, got).size
    if missing:
        f.append(Finding(
            "grid.work-missing", f"{missing} effectual block(s) of the plan never MAC'd", where,
        ))
    return f


def _check_ragged(nnz, idx, workqueue, splits: int, where: tuple) -> list[Finding]:
    rb, kb = idx.shape
    rs, wr, wk = (_host(x, n).astype(np.int64)
                  for x, n in zip(workqueue, ("row_starts", "work_row", "work_kblk")))
    if rs.shape != (rb + 1,) or int(rs[0]) != 0 or np.any(np.diff(rs) < 1):
        return [Finding("grid.queue-shape",
                        "row_starts is not a monotone [Rb+1] offset table starting at 0", where)]
    total = int(rs[-1])
    if total > wr.shape[0] or total > wk.shape[0]:
        return [Finding("grid.queue-shape",
                        f"total_work={total} exceeds the queue arrays ({wr.shape[0]}, {wk.shape[0]})",
                        where)]
    wr, wk = wr[:total], wk[:total]
    if np.any((wr < 0) | (wr >= rb)):
        return [Finding("grid.a-oob", f"work_row names block rows outside [0, {rb})", where)]
    if np.any((wk < 0) | (wk >= kb)):
        return [Finding("grid.b-oob", f"work_kblk dereferences K blocks outside [0, {kb})", where)]
    # the CTAs of row m take the items of its segment; work_row must agree
    seg_row = np.repeat(np.arange(rb, dtype=np.int64), np.diff(rs))
    if not np.array_equal(wr, seg_row):
        bad = int(np.nonzero(wr != seg_row)[0][0])
        return [Finding(
            "grid.zero-order",
            f"queue item {bad} (row {int(wr[bad])}) lies in row {int(seg_row[bad])}'s segment: "
            f"that row's CTAs accumulate it",
            where,
        )]
    if not np.array_equal(np.diff(rs), np.maximum(nnz.astype(np.int64), 1)):
        return [Finding(
            "grid.store-count",
            "per-row queue segment lengths != max(nnz, 1): the CTAs of some row walk "
            "another row's items or a gated row is not stored once",
            where,
        )]
    cnt = np.diff(rs)
    rows, steps = _walk(nnz, cnt, cnt, splits)
    return _coverage(rows * kb + wk[rs[rows] + steps], nnz, idx, where)


def _check_compacted(nnz, idx, kdim: int, splits: int, where: tuple) -> list[Finding]:
    rb, kb = idx.shape
    if kdim < 1:
        return [Finding("grid.store-count", f"kdim={kdim} < 1: an empty K grid has no store step",
                        where)]
    if kdim > kb:
        return [Finding("grid.a-oob", f"kdim={kdim} exceeds the {kb} idx columns", where)]
    f: list[Finding] = []
    max_nnz = int(nnz.max(initial=0))
    if kdim < max_nnz:
        f.append(Finding(
            "grid.work-missing",
            f"kdim={kdim} < max(nnz)={max_nnz}: rows with nnz > kdim silently drop their last MACs",
            where,
        ))
    cnt = nnz.astype(np.int64)
    rows, steps = _walk(nnz, cnt, np.full(rb, kdim, np.int64), splits)
    kblk = idx[rows, steps].astype(np.int64)
    if kblk.size and (kblk.min() < 0 or kblk.max() >= kb):
        return f + [Finding("grid.b-oob", f"idx dereferenced by the grid outside [0, {kb})", where)]
    got = rows * kb + kblk
    dup = got.size - np.unique(got).size
    if dup:
        f.append(Finding("grid.work-dup",
                         f"{dup} duplicate effectual idx entries double-accumulate a block", where))
    return f


def check_grid(nnz, idx, *, nb: int = 1, compact_grid="ragged", workqueue=None,
               kdim: int | None = None, splits: int = 1, where: tuple = ()) -> list[Finding]:
    """Abstractly interpret one kernel launch's CTAs against the plan.

    ``workqueue``/``kdim`` default to what the wrapper would derive from
    ``(nnz, idx)``; pass them to audit a hand-built (or corrupted)
    schedule.  ``splits`` is the launch's ``S`` (``kernel_splits``); every
    ``S >= 1`` must give a valid schedule.
    """
    from repro_torch.kernels.tensordash_spmm import _check_compact_grid, plan_workqueue

    compact_grid = _check_compact_grid(compact_grid)
    if nb < 1 or splits < 1:
        return [Finding("grid.queue-shape", f"nb={nb}, splits={splits}: need both >= 1", where)]
    nnz = _host(nnz, "nnz")
    idx = _host(idx, "idx")
    if compact_grid == "ragged":
        if workqueue is None:
            import torch

            workqueue = plan_workqueue(torch.from_numpy(nnz.astype(np.int32)),
                                       torch.from_numpy(idx.astype(np.int32)))
        return _check_ragged(nnz, idx, workqueue, splits, where)
    if kdim is None:
        kdim = max(int(nnz.max(initial=0)), 1) if compact_grid == "v2" else idx.shape[1]
    return _check_compacted(nnz, idx, int(kdim), splits, where)


def check_plan_grid(plan, *, nb: int = 1, compact_grid="ragged", splits: int = 1) -> list[Finding]:
    """:func:`check_grid` for a :class:`~repro_torch.runtime.plan.SparsityPlan`,
    auditing the exact queue the plan carries (not a re-derivation)."""
    wq = plan.workqueue() if compact_grid == "ragged" else None
    return check_grid(plan.nnz, plan.idx, nb=nb, compact_grid=compact_grid, workqueue=wq,
                      splits=splits)
