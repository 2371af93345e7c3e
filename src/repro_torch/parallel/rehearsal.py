"""Rehearse sharded code on one host: a pool of spawned CPU ranks in one
gloo process group.

    with RankPool(4, workdir) as pool:
        outs = pool.run(task, arg)          # task(arg) on every rank

``task`` runs in every rank at once, so its collectives meet; it must be a
module-level function (the ranks import its module to find it) and should
return host values (numpy arrays, numbers).  :func:`mesh` builds a named
``DeviceMesh`` over the pool's ranks, once per shape in each rank.

The rendezvous is a fresh file under ``workdir`` (no TCP port to clash
with another pool on the host), the process group has a ``timeout``, and
every :meth:`RankPool.run` a deadline of its own: a task that fails or
hangs on one rank stops the pool and raises in the caller, and the next
:meth:`RankPool.run` starts a new one.
"""
from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing as mp
import os
import queue
import traceback

import torch
import torch.distributed as dist

__all__ = ["RankPool", "mesh"]

_MESHES: dict = {}


def mesh(shape, names):
    """A ``DeviceMesh`` of this pool's CPU ranks, ``shape`` by ``names``
    (row-major over the ranks), made once per rank and shape; every rank
    must ask for it (making one is collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
        _MESHES[key] = DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names))
    return _MESHES[key]


def _serve(rank: int, world: int, init_file: str, timeout_s: float, threads: int, inbox, outbox):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args = task
            try:
                outbox.put((rank, True, fn(*args)))
            except Exception:  # reported to the caller, which raises
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned CPU ranks in one gloo group, fed tasks through
    queues (see the module docstring)."""

    _ids = itertools.count()

    def __init__(self, world: int, workdir, *, timeout: float = 60.0, threads: int = 1):
        self.world, self.workdir = world, os.fspath(workdir)
        self.timeout, self.threads = timeout, threads
        self._procs: list = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        init_file = os.path.join(self.workdir, f"rendezvous_{os.getpid()}_{next(self._ids)}")
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._outbox = ctx.Queue()
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, self.world, init_file, self.timeout, self.threads, self._inboxes[r],
                              self._outbox))
            for r in range(self.world)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, deadline: float | None = None) -> list:
        """``fn(*args)`` on every rank at once; the per-rank results in rank
        order.  Raises (and stops the pool) as soon as a rank raises, or if
        a rank has not answered within ``deadline`` seconds (default: the
        group's timeout plus a minute, so a hung collective times out
        first)."""
        if not self._procs:
            self._start()
        for box in self._inboxes:
            box.put((fn, args))
        deadline = self.timeout + 60.0 if deadline is None else deadline
        end = datetime.datetime.now() + datetime.timedelta(seconds=deadline)
        results = {}
        while len(results) < self.world:
            left = (end - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = self._outbox.get(timeout=max(left, 0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                self.close()
                raise TimeoutError(f"{fn.__name__}: no answer from {self.world - len(results)} rank(s) "
                                   f"within {deadline:.0f} s (dead ranks: {dead})") from None
            if not ok:  # the other ranks may wait in a collective for it: stop them all
                self.close()
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            results[rank] = value
        return [results[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank (politely, then by force)."""
        if not self._procs:
            return
        for box in self._inboxes:
            box.put(None)
        end = datetime.datetime.now() + datetime.timedelta(seconds=5)
        for p in self._procs:
            p.join(timeout=max((end - datetime.datetime.now()).total_seconds(), 0))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs = []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
