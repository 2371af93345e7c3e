"""Deterministic, seeded fault injection at the runtime's trust boundaries
(port of ``repro/resilience/faults.py``).

A :class:`FaultPlan` is a *replayable schedule* of faults: which fault kind
fires at which tick of which site, plus one ``numpy`` RNG (seeded) that all
corruption injectors draw from — so every chaos test is a regression test
(same plan + same seed => bit-identical faulty inputs).  The grammar, the
tick counters and the RNG are the JAX package's, unchanged: one plan string
and seed fire the same faults in both packages.

Injection happens only at trust boundaries — the places where bad data
*could* arrive in production:

* training loss / grads (NaN poisoning, :func:`train_poison`) and decode
  logits (:func:`poison_slots`),
* :class:`~repro_torch.runtime.plan.SparsityPlan` metadata
  (:func:`corrupt_plan`: the port's plans hold device tensors, so a host
  copy is corrupted and the result returned on the plan's device),
* :class:`~repro_torch.runtime.plan.PlanCache` entries and the on-disk
  TuningDB (:func:`corrupt_cache_entry`, :func:`corrupt_db_file`),
* checkpoint blobs (:func:`corrupt_file`), allocation failure
  (:func:`maybe_alloc_failure`), host-level straggler steps and
  preemption (``step_stall`` / ``preempt``).

Plans install ambiently (``with inject(plan): ...``) for sites that cannot
take a plan argument, or ride explicitly on the train launcher.  Ticks are
per-site call counters kept *on the plan*, so a replay that makes the same
sequence of calls fires the same faults.  The serve engine ticks the
JAX engine's sites (``serve.step``, ``serve.decode_chunk``,
``alloc:slot_caches``, ``alloc:grow_caches``) in the same order.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import time as _time

import numpy as np
import torch

__all__ = [
    "SimulatedFault",
    "SimulatedAllocFailure",
    "SimulatedShardFailure",
    "FaultSpec",
    "FaultPlan",
    "KINDS",
    "PLAN_CORRUPTIONS",
    "DB_CORRUPTIONS",
    "inject",
    "active",
    "corrupt_plan",
    "corrupt_cache_entry",
    "corrupt_db_file",
    "corrupt_file",
    "poison_slots",
    "train_poison",
    "maybe_alloc_failure",
    "stall",
]


class SimulatedFault(RuntimeError):
    """Base class for injected failures (never raised by real code paths)."""


class SimulatedAllocFailure(SimulatedFault):
    """Injected ``slot_caches``/``grow_caches`` allocation failure."""


class SimulatedShardFailure(SimulatedFault):
    """Injected failure of one shard in a sharded executor."""


#: the injector matrix — every kind is exercised by the chaos suite
KINDS = frozenset({
    "nan_logits", "inf_logits",   # serve: poison one slot's decode logits
    "nan_loss", "nan_grad",       # train: poison the loss / the grads
    "plan_corrupt",               # SparsityPlan metadata corruption
    "cache_corrupt",              # PlanCache entry corruption
    "db_corrupt",                 # on-disk TuningDB corruption
    "alloc_fail",                 # slot_caches/grow_caches allocation failure
    "shard_stall", "shard_fail",  # one slow / failed shard
    "step_stall",                 # host-side straggler step
    "preempt",                    # SIGTERM mid-run (preemption)
})


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires at site-ticks ``[at, at+count)``.

    ``slot`` targets a serve batch slot (-1 = every slot); ``secs`` is the
    stall duration for the ``*_stall`` kinds; ``where`` filters by sub-site
    (e.g. ``alloc_fail`` at ``"slot_caches"`` vs ``"grow_caches"``);
    ``mode`` pins a corruption mode (default: seeded choice from the plan's
    RNG)."""

    kind: str
    at: int = 0
    count: int = 1
    slot: int = -1
    secs: float = 0.0
    where: str = ""
    mode: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {sorted(KINDS)}"
            )

    def fires_at(self, t: int) -> bool:
        return self.at <= t < self.at + self.count


_INT_FIELDS = {"at", "count", "slot"}
_FLOAT_FIELDS = {"secs"}
_STR_FIELDS = {"where", "mode"}


class FaultPlan:
    """A seeded, replayable schedule of :class:`FaultSpec`\\ s.

    The grammar (CLI ``--inject-faults``) is ``kind@at[:k=v,...]`` joined by
    ``;`` — e.g. ``"nan_logits@0:slot=1;alloc_fail@0:where=grow_caches"``.
    ``fires(kind, tick)`` answers "does this kind fire now"; ``tick(site)``
    advances the per-site call counter (deterministic under replay: the same
    call sequence sees the same ticks).
    """

    def __init__(self, specs=(), *, seed: int = 0):
        self.specs: tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self._ticks: collections.Counter = collections.Counter()

    @classmethod
    def parse(cls, text: str | None, *, seed: int = 0) -> "FaultPlan":
        specs = []
        for part in filter(None, (p.strip() for p in (text or "").split(";"))):
            head, _, tail = part.partition(":")
            kind, _, at = head.partition("@")
            kw: dict = {"kind": kind.strip()}
            if at:
                kw["at"] = int(at)
            for item in filter(None, (i.strip() for i in tail.split(","))):
                k, _, v = item.partition("=")
                k, v = k.strip(), v.strip()
                if k in _INT_FIELDS:
                    kw[k] = int(v)
                elif k in _FLOAT_FIELDS:
                    kw[k] = float(v)
                elif k in _STR_FIELDS:
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault field {k!r} in {part!r}")
            specs.append(FaultSpec(**kw))
        return cls(specs, seed=seed)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, specs={list(self.specs)!r})"

    def reset(self) -> None:
        """Rewind ticks and reseed the RNG — replay from the top."""
        self._ticks.clear()
        self.rng = np.random.default_rng(self.seed)

    def tick(self, site: str) -> int:
        t = self._ticks[site]
        self._ticks[site] += 1
        return t

    def fires(self, kind: str, at: int | None = None, *,
              where: str = "") -> list[FaultSpec]:
        out = []
        for s in self.specs:
            if s.kind != kind:
                continue
            if at is not None and not s.fires_at(at):
                continue
            if s.where and s.where != where:
                continue
            out.append(s)
        return out


_ACTIVE: contextvars.ContextVar[FaultPlan | None] = contextvars.ContextVar(
    "fault_plan", default=None
)


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` as the ambient fault plan for this extent (consumed
    by sites that take no plan argument: the sharded executors, cache
    allocation)."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def active() -> FaultPlan | None:
    return _ACTIVE.get()


# -- corruption injectors ---------------------------------------------------

#: SparsityPlan metadata corruption modes — each violates an invariant the
#: static verifier (`repro_torch.analysis.plan_check`) provably catches
PLAN_CORRUPTIONS = ("nnz-range", "idx-oob", "row-starts", "queue-entry")


def _host(x) -> np.ndarray:
    """A writable int32 host copy of plan metadata (a tensor on any device)."""
    # lint: allow-host-sync: the fault injector edits a host copy, off the hot path
    return torch.as_tensor(x).cpu().numpy().astype(np.int32, copy=True)


def corrupt_plan(plan, *, rng=None, mode: str = ""):
    """A copy of ``plan`` with one seeded metadata corruption.

    Every mode produces a plan that FAILS ``check_plan(level="full")``
    (asserted by the chaos suite, which keeps the injector honest): a
    count outside ``[0, Kb]``, an out-of-range K-block index, inconsistent
    CSR offsets, or a work-queue entry that disagrees with the schedule.
    ``nnz-range`` and ``row-starts`` violate O(Rb) structure and are caught
    by the cheap ``"boundary"`` tier too; ``idx-oob`` and ``queue-entry``
    are content faults only the O(entries) ``"full"`` tier sees.
    The corruption is made on a host copy; the returned plan holds its
    metadata on the device of ``plan``'s.  The input is untouched.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    mode = mode or PLAN_CORRUPTIONS[int(rng.integers(len(PLAN_CORRUPTIONS)))]
    nnz, idx = _host(plan.nnz), _host(plan.idx)
    rs, wr, wk = (_host(x) for x in plan.workqueue())
    kb = plan.k_blocks
    if mode == "nnz-range":
        nnz[0] = kb + 1
    elif mode == "idx-oob":
        nnz[0] = max(int(nnz[0]), 1)
        idx[0, 0] = kb  # one past the last valid K block
    elif mode == "row-starts":
        rs[-1] = rs[-1] + 1  # total no longer equals sum(max(nnz, 1))
    elif mode == "queue-entry":
        if wk.size == 0:
            nnz[0] = kb + 1  # degenerate queue: fall back to a count fault
        else:
            wk[0] = wk[0] + 1  # disagrees with the derived entry stream
    else:
        raise ValueError(f"unknown plan corruption mode {mode!r}")
    dev = torch.as_tensor(plan.idx).device
    nnz, idx, rs, wr, wk = (torch.from_numpy(x).to(dev) for x in (nnz, idx, rs, wr, wk))
    return dataclasses.replace(plan, nnz=nnz, idx=idx, row_starts=rs, work_row=wr,
                               work_kblk=wk, _host={})


def corrupt_cache_entry(cache, *, rng=None, mode: str = ""):
    """Corrupt one (seeded-choice) stored plan in a ``PlanCache`` in place.

    Returns the cache key that was corrupted (None when the cache is
    empty).  Models a poisoned/bit-flipped cached schedule.  The entry keeps
    its source tensor and version, so a lookup still hits the corrupt plan;
    recovery is ``PlanCache.scrub()`` (which evicts it, so the next lookup
    replans) or the store-time verifier on the replacement.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    keys = sorted(cache._entries.keys(), key=repr)
    if not keys:
        return None
    k = keys[int(rng.integers(len(keys)))]
    src, version, plan = cache._entries[k]
    cache._entries[k] = (src, version, corrupt_plan(plan, rng=rng, mode=mode))
    return k


#: on-disk TuningDB corruption modes
DB_CORRUPTIONS = ("garbage", "truncate", "version")


def corrupt_db_file(path, *, rng=None, mode: str = "") -> str:
    """Corrupt a TuningDB JSON file on disk; returns the mode applied.

    ``garbage`` overwrites with non-JSON bytes, ``truncate`` cuts the file
    mid-record, ``version`` rewrites the schema version to an unknown one.
    ``TuningDB.load`` must degrade every mode to an empty DB with a warning
    (never crash, never serve corrupt policies).
    """
    import json
    import os

    rng = np.random.default_rng(0) if rng is None else rng
    mode = mode or DB_CORRUPTIONS[int(rng.integers(len(DB_CORRUPTIONS)))]
    path = os.fspath(path)
    if mode == "garbage":
        with open(path, "w") as f:
            f.write("{this is not json" + "".join(
                chr(int(c)) for c in rng.integers(33, 126, size=32)))
    elif mode == "truncate":
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[: max(len(raw) // 2, 1)])
    elif mode == "version":
        with open(path) as f:
            doc = json.load(f)
        doc["version"] = 10 ** 6
        with open(path, "w") as f:
            json.dump(doc, f)
    else:
        raise ValueError(f"unknown DB corruption mode {mode!r}")
    return mode


def corrupt_file(path, *, rng=None) -> None:
    """Overwrite an arbitrary file (e.g. a checkpoint array blob) with
    seeded garbage bytes of the same length — loading it must fail, which is
    what the checkpoint fallback path contains."""
    import os

    rng = np.random.default_rng(0) if rng is None else rng
    n = max(os.path.getsize(os.fspath(path)), 16)
    with open(os.fspath(path), "wb") as f:
        f.write(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())


# -- runtime hooks ----------------------------------------------------------

def poison_slots(plan: FaultPlan | None, chunk_index: int, slots: int):
    """int32 ``[slots]`` poison codes for one decode chunk: 0 = clean,
    1 = NaN logits, 2 = Inf logits.  ``slot=-1`` specs poison every slot."""
    p = np.zeros((slots,), np.int32)
    if plan is None:
        return p
    for code, kind in ((1, "nan_logits"), (2, "inf_logits")):
        for s in plan.fires(kind, chunk_index):
            if s.slot < 0:
                p[:] = code
            else:
                p[s.slot % slots] = code
    return p


def train_poison(plan: FaultPlan | None, step_index: int) -> int:
    """Train-step poison code: 0 = clean, 1 = NaN loss, 2 = NaN grads."""
    if plan is None:
        return 0
    if plan.fires("nan_grad", step_index):
        return 2
    if plan.fires("nan_loss", step_index):
        return 1
    return 0


def maybe_alloc_failure(plan: FaultPlan | None, where: str) -> None:
    """Raise :class:`SimulatedAllocFailure` when an ``alloc_fail`` spec
    fires at this site's current tick (sites: ``"slot_caches"``,
    ``"grow_caches"``)."""
    if plan is None:
        return
    t = plan.tick(f"alloc:{where}")
    if plan.fires("alloc_fail", t, where=where):
        raise SimulatedAllocFailure(
            f"injected allocation failure at {where} (call {t})"
        )


def stall(plan: FaultPlan | None, kind: str, at: int) -> float:
    """Host-side sleep for every matching ``*_stall`` spec; returns the
    total injected seconds."""
    total = 0.0
    if plan is None:
        return total
    for s in plan.fires(kind, at):
        _time.sleep(s.secs)
        total += s.secs
    return total
