"""Structured degradation log: every detected fault and its containment
(port of ``repro/resilience/log.py``, pure Python, unchanged in behaviour).

Detection without a record is worthless at production scale — an operator
replaying a chaos run needs to know *which* fault class fired, *where* it
was detected, and *what* the system did about it.  :class:`ResilienceLog`
is that record: an append-only list of :class:`ResilienceEvent` rows, one
per degradation, surfaced by the train launcher
(``repro_torch.launch.train``) as a summary table and as JSON.

Sites that cannot be handed a log explicitly (``restore_latest``, the
dynamic-sparsity controller's replan) report through the *ambient* log:
``with use_log(log): ...`` installs one for the dynamic extent of a run,
and module-level :func:`record` writes to it (dropping the event when none
is installed — detection still warns; the log is observability, never a
control dependency).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import time
import warnings

__all__ = [
    "ResilienceEvent",
    "ResilienceLog",
    "use_log",
    "ambient_log",
    "record",
    "capture_warnings",
]


@dataclasses.dataclass(frozen=True)
class ResilienceEvent:
    """One detected fault and the containment action taken for it.

    ``kind`` is the fault class (``"nonfinite"``, ``"plan-corrupt"``,
    ``"db-corrupt"``, ``"cache-corrupt"``, ``"alloc"``, ``"shard"``,
    ``"deadline"``, ``"queue"``, ``"checkpoint"``, ``"warning"`` ...),
    ``site`` the detection site (``"serve.decode.watchdog"``,
    ``"train.step"``, ``"runtime.matmul"`` ...), ``action`` the contained
    behavior (``"retire-slot"``, ``"skip-step"``, ``"replan"``, ``"shed"``,
    ``"expire"``, ``"fallback-unsharded"``, ``"checkpoint-abort"`` ...).
    """

    time: float
    kind: str
    site: str
    action: str
    detail: dict = dataclasses.field(default_factory=dict, compare=False)

    def to_dict(self) -> dict:
        return {"time": self.time, "kind": self.kind, "site": self.site,
                "action": self.action, **self.detail}


class ResilienceLog:
    """Append-only event log with per-(kind, action) counts."""

    def __init__(self) -> None:
        self.events: list[ResilienceEvent] = []
        self._t0 = time.monotonic()

    def __len__(self) -> int:
        return len(self.events)

    def record(self, kind: str, site: str, action: str, **detail) -> ResilienceEvent:
        ev = ResilienceEvent(time=time.monotonic() - self._t0, kind=kind,
                             site=site, action=action, detail=detail)
        self.events.append(ev)
        return ev

    def by_kind(self, kind: str) -> list[ResilienceEvent]:
        return [e for e in self.events if e.kind == kind]

    def counts(self) -> dict[tuple[str, str], int]:
        out: dict[tuple[str, str], int] = {}
        for e in self.events:
            k = (e.kind, e.action)
            out[k] = out.get(k, 0) + 1
        return out

    def summary(self) -> str:
        """Human-readable digest: one line per (kind -> action) class."""
        if not self.events:
            return "resilience: no degradation events"
        lines = [f"resilience: {len(self.events)} degradation event(s)"]
        for (kind, action), n in sorted(self.counts().items()):
            sites = sorted({e.site for e in self.events
                            if e.kind == kind and e.action == action})
            lines.append(f"  {kind} -> {action} x{n}  [{', '.join(sites)}]")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self.events], default=str)


_AMBIENT: contextvars.ContextVar[ResilienceLog | None] = contextvars.ContextVar(
    "resilience_log", default=None
)


@contextlib.contextmanager
def use_log(log: ResilienceLog):
    """Install ``log`` as the ambient resilience log for this extent."""
    token = _AMBIENT.set(log)
    try:
        yield log
    finally:
        _AMBIENT.reset(token)


def ambient_log() -> ResilienceLog | None:
    return _AMBIENT.get()


def record(kind: str, site: str, action: str, **detail) -> ResilienceEvent | None:
    """Record into the ambient log; a no-op (returns None) when none is
    installed.  Deep recovery sites call this so observability never becomes
    a required constructor argument on hot paths."""
    log = _AMBIENT.get()
    if log is None:
        return None
    return log.record(kind, site, action, **detail)


@contextlib.contextmanager
def capture_warnings(log: ResilienceLog, *, site: str = "warnings"):
    """Mirror every warning emitted in this extent into ``log`` as a
    ``kind="warning"`` event — warnings still reach their normal sink (the
    degradation stays *loud*); the log just also remembers it.  Lets the
    launchers fold pre-existing degrade-with-warning paths (TuningDB
    corruption, checkpoint skips) into the structured record without
    rewriting them."""
    prev = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        log.record("warning", site, "warned",
                   message=str(message), category=category.__name__)
        prev(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    try:
        yield log
    finally:
        warnings.showwarning = prev
