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
* Sharded trees: ``shardings=`` is the tree of spec tuples of the leaves
  (``param_pspecs``; ``train.step.state_specs`` for a train state) on the
  ambient runtime's mesh.  :func:`save` gathers each leaf in turn to the
  host of the mesh's first rank, which writes the same format (the others
  wait); :func:`restore` gives each rank its ``local_shard`` of every
  stored leaf, so a run restarts onto another mesh shape (elastic restart).
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
import torch.distributed as dist

from repro_torch.parallel import sharding as S

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


def _spec_paths(like, specs, prefix: str = "") -> dict:
    """``{path: spec tuple}`` of a spec tree laid over ``like`` (paths as
    :func:`_flatten` names them; ``None`` for a leaf that is no tensor)."""
    def at(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(like, dict):
        items = ((at(k), like[k], specs[k]) for k in sorted(like))
    elif isinstance(like, tuple) and hasattr(like, "_fields"):
        items = ((at(f), v, sp) for f, v, sp in zip(like._fields, like, specs))
    elif isinstance(like, (list, tuple)):
        items = ((at(i), v, sp) for i, (v, sp) in enumerate(zip(like, specs)))
    elif like is None:
        return {}
    else:
        return {prefix: specs}
    out = {}
    for k, v, sp in items:
        out.update(_spec_paths(v, sp, k))
    return out


def _policy():
    from repro_torch.runtime import runtime as rtm  # local: keep the checkpoint import light

    policy = rtm.active_policy()
    if policy.mesh is None:
        raise ValueError("shardings= needs the ambient runtime's sharding policy to have a mesh")
    return policy


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


def _from_numpy(arr: np.ndarray, name: str | None, like, cut=None):
    """The stored array as a leaf like ``like``: a tensor on ``like``'s
    device in its dtype (``cut`` first takes this rank's shard of it), or a
    Python scalar of ``like``'s type."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if name is not None:
        dtype, view = _BY_NAME[name]
        t = t.view(view).view(dtype)
    if not isinstance(like, torch.Tensor):
        return type(like)(t.item())
    if cut is not None:
        t = cut(t).clone()  # its own storage: the whole array is freed
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"stored shape {tuple(t.shape)} != {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def save(directory: str, step: int, tree, *, keep: int = 3, shardings=None) -> str:
    """Atomically write checkpoint ``step``; prune to ``keep`` newest.
    With ``shardings`` (the spec tree of ``tree``'s shards on the ambient
    mesh) each leaf is gathered in turn to the host of the mesh's first
    rank (:func:`~repro_torch.parallel.sharding.gather_to_first`), which
    writes; every rank returns once it has."""
    directory = os.fspath(directory)
    if shardings is None:
        return _write(directory, step, tree, keep)
    policy = _policy()
    whole = S.map_specs(lambda x, sp: S.gather_to_first(x, sp, policy), tree, shardings)
    group = S.axis_group(policy.mesh, tuple(S.axis_sizes(policy.mesh)))[0]
    if dist.get_rank() == int(policy.mesh.mesh.reshape(-1)[0]):
        _write(directory, step, whole, keep)
    dist.barrier(group=group)
    return os.path.join(directory, f"step_{step:012d}")


def _write(directory: str, step: int, tree, keep: int) -> str:
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
    stored shape that differs raises).  With ``shardings`` (the spec tree
    of ``like``'s leaves on the ambient mesh, the same tree of specs
    ``param_pspecs`` gives) each rank keeps its ``local_shard`` of every
    stored leaf, whatever mesh wrote it: an elastic restart onto another
    mesh shape."""
    cuts = {}
    if shardings is not None:
        policy = _policy()
        cuts = {k: (lambda t, sp=sp: S.local_shard(t, sp, policy)) for k, sp in _spec_paths(like, shardings).items()
                if sp is not None}
    base = os.path.join(os.fspath(directory), f"step_{step:012d}")
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    with np.load(os.path.join(base, "arrays.npz")) as data:
        leaves = {k: _from_numpy(data[k], dtypes.get(k), leaf, cuts.get(k)) for k, leaf in _flatten(like).items()}
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
