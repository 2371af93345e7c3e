"""Fault-tolerant checkpointing: atomic, keep-k, corrupt-step fallback
(port of ``repro/checkpoint/manager.py``).

* Atomic: write to ``<dir>/tmp.<step>`` then ``rename`` to
  ``<dir>/step_<012d>`` — a preemption mid-write never corrupts the latest
  checkpoint.
* keep-k: older checkpoints garbage-collected after a successful save.
* The on-disk format is the JAX package's: ``arrays.npz`` keyed by
  ``/``-joined tree paths plus ``meta.json`` (step, keys, and a ``dtypes``
  sidecar for the types npz cannot hold).  bfloat16 is stored as its
  ``uint16`` bit pattern and ``float8_e4m3fn`` as ``uint8``, written through
  ``Tensor.view`` and read back the same way (no ``ml_dtypes``), so either
  package reads the other's checkpoints.
* Trees are nested dicts, lists (the port's per-layer parameter list; a
  hybrid model's groups are lists of lists) and
  named tuples (the optimizer's ``OptState``); leaves are tensors and
  Python scalars (``OptState.step``).  :func:`restore` places
  each tensor on the device and in the dtype of the ``like`` tree's leaf.
  Resharding on load (``shardings=``) waits for the sharded train step
  (ROADMAP queue 1, item 14b).
* Preemption: :class:`PreemptionGuard` installs a SIGTERM handler; the
  train loop polls ``should_save`` and checkpoints before exit.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading

import numpy as np
import torch

__all__ = ["save", "restore", "restore_latest", "latest_step", "all_steps", "PreemptionGuard"]

_SEP = "/"
#: dtypes npz cannot hold: sidecar name, the integer type of the same width
#: the tensor is viewed as, and the numpy type stored (the JAX package's)
_EXTENDED = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
}
_BY_NAME = {name: (dt, view) for dt, (name, view, _) in _EXTENDED.items()}


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` with ``/``-joined dict keys, sequence indices and
    named-tuple field names (the JAX package's naming)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    def at(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, at(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, at(f)) for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, at(i)) for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as the array npz stores, and its sidecar dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        ext = _EXTENDED.get(t.dtype)
        if ext is not None:
            name, view, stored = ext
            return t.view(view).cpu().numpy().view(stored), name
        return t.cpu().numpy(), None
    return np.asarray(leaf), None


def _from_numpy(arr: np.ndarray, name: str | None, like):
    """The stored array as a leaf like ``like``: a tensor on ``like``'s
    device in its dtype, or a Python scalar of ``like``'s type."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if name is not None:
        dtype, view = _BY_NAME[name]
        t = t.view(view).view(dtype)
    if not isinstance(like, torch.Tensor):
        return type(like)(t.item())
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"stored shape {tuple(t.shape)} != {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically write checkpoint ``step``; prune to ``keep`` newest."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for k, leaf in _flatten(tree).items():
        arrays[k], name = _to_numpy(leaf)
        if name is not None:
            dtypes[k] = name
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays), "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:012d}"), ignore_errors=True)
    return final


def all_steps(directory: str) -> list[int]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for n in os.listdir(directory):
        if n.startswith("step_") and os.path.exists(os.path.join(directory, n, "meta.json")):
            out.append(int(n[len("step_"):]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like, *, shardings=None):
    """Load checkpoint ``step`` into the structure of ``like``: each tensor
    on the device and in the dtype of ``like``'s leaf at the same path (a
    stored shape that differs raises)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=): resharding on load waits for distributed execution "
            "(ROADMAP queue 1, item 14b)")
    base = os.path.join(os.fspath(directory), f"step_{step:012d}")
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    with np.load(os.path.join(base, "arrays.npz")) as data:
        leaves = {k: _from_numpy(data[k], dtypes.get(k), leaf) for k, leaf in _flatten(like).items()}
    return _unflatten(like, leaves)


def restore_latest(directory: str, like, *, shardings=None):
    """Load the newest *readable* checkpoint: ``(step, tree)``.

    Graceful degradation for on-disk corruption (a torn write that somehow
    survived the atomic rename, bit rot, a truncated copy): a checkpoint
    that fails to load is skipped — loudly, with a warning and a
    ``ResilienceLog`` event — and the next-older one is tried.  Returns
    ``(None, None)`` when no checkpoint is readable (callers start fresh).
    """
    import warnings

    from repro_torch.resilience.log import record as _record

    for step in reversed(all_steps(directory)):
        try:
            return step, restore(directory, step, like, shardings=shardings)
        except NotImplementedError:
            raise
        except Exception as e:  # np.load/json/KeyError zoo — skip, try older
            warnings.warn(
                f"checkpoint step {step} in {os.fspath(directory)!r} is unreadable "
                f"({type(e).__name__}: {e}); trying an older checkpoint",
                RuntimeWarning, stacklevel=2,
            )
            _record("checkpoint", "checkpoint.restore_latest", "skip-corrupt",
                    step=step, error=f"{type(e).__name__}: {e}")
    return None, None


class PreemptionGuard:
    """SIGTERM-aware save trigger for preemptible fleets.  :meth:`close`
    puts back the handler it replaced."""

    def __init__(self):
        self._flag = threading.Event()
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # not in the main thread

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def should_save(self) -> bool:
        return self._flag.is_set()

    def close(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
