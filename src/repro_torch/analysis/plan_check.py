"""Static CSR plan verification (port of the single-device part of
``repro/analysis/plan_check.py``) — prove a plan, don't run it.

``verify_plan`` re-derives every invariant a
:class:`~repro_torch.runtime.plan.SparsityPlan` is built to satisfy and reports
each violation as a structured :class:`Finding` with a stable code, in
O(entries) host numpy:

* ``row_starts`` is exactly ``concat([0], cumsum(max(nnz, 1)))`` — monotone
  by construction, one gated zero-fill step per all-zero row;
* ``work_row``/``work_kblk`` have the flat ``Rb * Kb`` footprint, a queue
  prefix of length ``row_starts[-1]`` that is the row-major effectual-entry
  stream of ``(nnz, idx)``, and a zeroed tail;
* per-row indices ``idx[r, :nnz[r]]`` are sorted, unique and in ``[0, Kb)``,
  and the tail repeats the last effectual index (all-zero rows stay zero) —
  the convention that lets skipped v1/v2 grid steps revisit a resident block.

Two levels: ``"boundary"`` is the O(Rb) structural subset (shapes, ``nnz``
range, ``row_starts`` cumsum, queue lengths) cheap enough to run on every
new plan; ``"full"`` adds the O(entries) content checks.  The
checks mirror the paper's schedule-validity condition (§3.7): every
effectual MAC appears in the queue exactly once, so proving the metadata
proves the schedule without issuing a grid.

The metadata is copied to the host once per array (a plan on the card
costs one device-to-host copy each).  The shard and transpose checks wait
for the slices that port sharding and the backward pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "LEVELS",
    "Finding",
    "PlanVerificationError",
    "verify_csr",
    "verify_plan",
    "check_plan",
]

#: validation policy levels, in increasing cost
LEVELS = ("off", "boundary", "full")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant: a stable machine-readable ``code``
    (``"plan.row-starts"``, ``"grid.a-oob"``, ...), a human message, and
    ``where`` — a context path such as ``("shard", 3)``."""

    code: str
    message: str
    where: tuple = ()

    def __str__(self) -> str:
        loc = "".join(f"[{w}]" for w in self.where)
        return f"{self.code}{loc}: {self.message}"


class PlanVerificationError(ValueError):
    """A plan failed verification; ``.findings`` carries the details."""

    def __init__(self, findings: list[Finding]):
        self.findings = list(findings)
        super().__init__(
            "plan verification failed:\n  " + "\n  ".join(map(str, findings))
        )


def _check_level(level: str) -> None:
    if level not in LEVELS:
        raise ValueError(f"validate level {level!r} not one of {LEVELS}")


def _host(x, name: str) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a host array."""
    del name
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def verify_csr(nnz, idx, row_starts=None, work_row=None, work_kblk=None, *,
               level: str = "full", where: tuple = ()) -> list[Finding]:
    """Verify one raw ``(nnz, idx[, queue])`` CSR schedule.  The shared core
    of :func:`verify_plan` and the per-shard checks."""
    _check_level(level)
    if level == "off":
        return []
    f: list[Finding] = []
    nnz = _host(nnz, "nnz")
    idx = _host(idx, "idx")

    # -- boundary: O(Rb) structure -----------------------------------------
    if nnz.ndim != 1 or idx.ndim != 2 or idx.shape[0] != nnz.shape[0]:
        f.append(Finding(
            "plan.shape",
            f"nnz {nnz.shape} / idx {idx.shape} are not ([Rb], [Rb, Kb])",
            where,
        ))
        return f  # nothing downstream is well-defined
    rb, kb = idx.shape
    if nnz.size and (nnz.min() < 0 or nnz.max() > kb):
        f.append(Finding(
            "plan.nnz-range",
            f"nnz outside [0, {kb}]: min={int(nnz.min())} max={int(nnz.max())}",
            where,
        ))
        return f  # row_starts / queue checks would index garbage
    work = np.maximum(nnz.astype(np.int64), 1)
    queue_ok = True
    if row_starts is not None:
        rs = _host(row_starts, "row_starts")
        if rs.shape != (rb + 1,):
            f.append(Finding(
                "plan.row-starts",
                f"row_starts shape {rs.shape} != ({rb + 1},)", where,
            ))
            queue_ok = False
        elif int(rs[0]) != 0 or not np.array_equal(np.diff(rs.astype(np.int64)), work):
            f.append(Finding(
                "plan.row-starts",
                "row_starts != concat([0], cumsum(max(nnz, 1)))", where,
            ))
            queue_ok = False
    for name, w in (("work_row", work_row), ("work_kblk", work_kblk)):
        if w is not None and _host(w, name).shape != (rb * kb,):
            f.append(Finding(
                "plan.queue-len",
                f"{name} shape {_host(w, name).shape} != ({rb * kb},)", where,
            ))
            queue_ok = False
    if row_starts is not None and queue_ok and int(rs[-1]) > rb * kb:
        f.append(Finding(
            "plan.queue-len",
            f"row_starts[-1]={int(rs[-1])} exceeds the "
            f"flat queue footprint {rb * kb}",
            where,
        ))
        queue_ok = False
    if level == "boundary":
        return f

    # -- full: O(entries) content ------------------------------------------
    cols = np.arange(kb, dtype=np.int64)[None, :]
    valid = cols < nnz[:, None]
    if idx.size and (idx.min() < 0 or idx.max() >= kb):
        f.append(Finding(
            "plan.idx-bounds",
            f"idx outside [0, {kb}): min={int(idx.min())} max={int(idx.max())}",
            where,
        ))
        return f  # queue derivation below would index out of range
    # strictly ascending within each row's effectual prefix = sorted + unique
    adjacent = valid[:, 1:] & valid[:, :-1]
    if np.any(adjacent & (idx[:, 1:] <= idx[:, :-1])):
        f.append(Finding(
            "plan.idx-sorted",
            "idx[r, :nnz[r]] not strictly ascending (unsorted or duplicate)",
            where,
        ))
    # tail: repeat the last effectual index; all-zero rows stay all-zero
    last = idx[np.arange(rb), np.maximum(nnz - 1, 0)]
    last = np.where(nnz > 0, last, 0)
    tail = cols >= work[:, None]
    if np.any(idx[tail] != np.broadcast_to(last[:, None], (rb, kb))[tail]):
        f.append(Finding(
            "plan.idx-tail",
            "idx tail does not repeat the last effectual index "
            "(all-zero rows must stay all-zero)",
            where,
        ))
    if row_starts is None or work_row is None or work_kblk is None or not queue_ok:
        return f
    rs = _host(row_starts, "row_starts").astype(np.int64)
    wr = _host(work_row, "work_row").astype(np.int64)
    wk = _host(work_kblk, "work_kblk").astype(np.int64)
    total = int(rs[-1])
    want_wr = np.repeat(np.arange(rb, dtype=np.int64), work)
    if not np.array_equal(wr[:total], want_wr):
        f.append(Finding(
            "plan.queue-row",
            "work_row prefix != repeat(arange(Rb), max(nnz, 1))", where,
        ))
    else:
        # wk[t] must be the t-th row-major effectual entry (a placeholder
        # entry of an all-zero row reads idx[r, 0] == 0 by the tail rule)
        slot = np.arange(total, dtype=np.int64) - rs[want_wr]
        if not np.array_equal(wk[:total], idx[want_wr, slot]):
            f.append(Finding(
                "plan.queue-kblk",
                "work_kblk prefix is not the row-major effectual-entry "
                "stream of (nnz, idx)",
                where,
            ))
    if np.any(wr[total:] != 0) or np.any(wk[total:] != 0):
        f.append(Finding(
            "plan.queue-tail",
            "queue tail past row_starts[-1] is not zeroed", where,
        ))
    return f


def verify_plan(plan, geometry=None, *, level: str = "full") -> list[Finding]:
    """All violated invariants of ``plan`` (empty list = verified).

    ``geometry``, when given, is an expected ``(shape, bm, bk)`` triple to
    cross-check the plan against (e.g. the operand a caller is about to
    execute with); by default the plan's own geometry fields are used.
    """
    _check_level(level)
    if level == "off":
        return []
    f: list[Finding] = []
    shape, bm, bk = (
        geometry if geometry is not None else (plan.shape, plan.bm, plan.bk)
    )
    if geometry is not None and (tuple(plan.shape), plan.bm, plan.bk) != (
        tuple(shape), bm, bk
    ):
        f.append(Finding(
            "plan.shape",
            f"plan geometry ({plan.shape}, bm={plan.bm}, bk={plan.bk}) != "
            f"expected ({tuple(shape)}, bm={bm}, bk={bk})",
        ))
    if shape[0] % bm or shape[1] % bk:
        f.append(Finding(
            "plan.shape",
            f"shape {tuple(shape)} not divisible by block ({bm}, {bk})",
        ))
        return f
    rb, kb = shape[0] // bm, shape[1] // bk
    nnz = _host(plan.nnz, "nnz")
    idx = _host(plan.idx, "idx")
    if nnz.shape != (rb,) or idx.shape != (rb, kb):
        f.append(Finding(
            "plan.shape",
            f"nnz {nnz.shape} / idx {idx.shape} do not match the "
            f"({rb}, {kb}) block grid of shape {tuple(shape)}",
        ))
        return f
    f.extend(verify_csr(
        nnz, idx, plan.row_starts, plan.work_row, plan.work_kblk, level=level,
    ))
    return f


def check_plan(plan, geometry=None, *, level: str = "full") -> None:
    """Raise :class:`PlanVerificationError` unless ``plan`` verifies clean."""
    findings = verify_plan(plan, geometry, level=level)
    if findings:
        raise PlanVerificationError(findings)
