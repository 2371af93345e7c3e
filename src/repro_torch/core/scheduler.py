"""Bit-exact functional model of the TensorDash hardware scheduler (port of
``repro/core/scheduler.py``, in numpy).

Each of the N multiplier lanes has an (up to) 8-input multiplexer.  For lane
``i`` the selectable (step, lane) movements, in static priority order, are
``(+0, i)`` (dense), ``(+1, i)``, ``(+2, i)`` (lookahead), then
``(+1, i-1)``, ``(+1, i+1)``, ``(+2, i-2)``, ``(+2, i+2)``, ``(+1, i-3)``
(lookaside, lane arithmetic mod N); ``lookahead=1`` keeps the step <= 1
options.  A hierarchical combinational scheduler picks one movement per
lane so that every effectual (A, B) pair is consumed exactly once: lanes are
grouped in levels whose option sets are disjoint, and each level removes
its selections from the effectual-pair bits ``Z`` before the next.

:func:`make_schedule_step` works on boolean arrays with any leading batch
dimensions, so one call schedules many PE rows at once; its selections,
remaining bits and drain counts equal the JAX model's bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

__all__ = [
    "connectivity",
    "levels",
    "make_schedule_step",
    "drain_count",
    "ScheduleStepResult",
]

# Lookaside movements (step, delta-lane) in the paper's priority order.
_LOOKASIDE = ((1, -1), (1, +1), (2, -2), (2, +2), (1, -3))


@functools.lru_cache(maxsize=None)
def connectivity(n_lanes: int = 16, lookahead: int = 2):
    """Movement tables: ``(steps, lanes)`` int32 arrays ``[n_lanes,
    n_options]`` giving each lane's mux options (step, source lane) in
    priority order."""
    opts = [(0, 0)]
    opts += [(s, 0) for s in range(1, lookahead + 1)]
    opts += [(s, d) for (s, d) in _LOOKASIDE if s <= lookahead]
    steps = np.array([[s for (s, _) in opts] for _ in range(n_lanes)], np.int32)
    lanes = np.array(
        [[(i + d) % n_lanes for (_, d) in opts] for i in range(n_lanes)], np.int32
    )
    return steps, lanes


@functools.lru_cache(maxsize=None)
def levels(n_lanes: int = 16, lookahead: int = 2):
    """Greedy conflict-free level assignment (tuple of tuples of lane ids):
    two lanes share a level iff their option sets are disjoint."""
    steps, lanes = connectivity(n_lanes, lookahead)
    option_sets = [set(zip(steps[i].tolist(), lanes[i].tolist())) for i in range(n_lanes)]
    lvls: list[list[int]] = []
    for i in range(n_lanes):
        for lvl in lvls:
            if all(not (option_sets[i] & option_sets[j]) for j in lvl):
                lvl.append(i)
                break
        else:
            lvls.append([i])
    return tuple(tuple(l) for l in lvls)


class ScheduleStepResult(NamedTuple):
    sel: np.ndarray  # [..., n_lanes] int32 option index; == n_options means idle
    z_out: np.ndarray  # [..., depth, n_lanes] bool, remaining effectual pairs
    advance: np.ndarray  # [...] int32 in [1, depth]: staging-buffer rows drained


def drain_count(z_out: np.ndarray) -> np.ndarray:
    """The AS signal: the number of leading fully drained staging-buffer
    rows (row 0 always drains: its dense option is its lane's first)."""
    depth = z_out.shape[-2]
    empty = ~np.any(z_out, axis=-1)  # [..., depth]
    adv = np.ones(z_out.shape[:-2], np.int32)
    for r in range(1, depth):
        adv = np.where(np.all(empty[..., : r + 1], axis=-1), np.int32(r + 1), adv)
    return adv


def make_schedule_step(n_lanes: int = 16, lookahead: int = 2):
    """The single-cycle scheduler: ``Z [..., lookahead+1, n_lanes]`` bool
    (True = pair still to consume) -> :class:`ScheduleStepResult`.  Each
    lane's priority encoder is unrolled over its options in level order,
    as in the JAX model, so the results are bit-identical."""
    steps_np, lanes_np = connectivity(n_lanes, lookahead)
    lvls = levels(n_lanes, lookahead)
    n_options = steps_np.shape[1]
    depth = lookahead + 1
    flat = (steps_np * n_lanes + lanes_np).tolist()

    def schedule_step(z) -> ScheduleStepResult:
        z = np.asarray(z, dtype=bool)
        if z.shape[-2:] != (depth, n_lanes):
            raise ValueError(f"Z of shape {z.shape} is not [..., {depth}, {n_lanes}]")
        batch = z.shape[:-2]
        zf = [z[..., s, l].copy() for s in range(depth) for l in range(n_lanes)]
        sel = np.empty(batch + (n_lanes,), np.int32)
        for lvl in lvls:
            for lane in lvl:
                pick = np.full(batch, n_options, np.int32)
                taken = np.zeros(batch, bool)
                chosen = []
                for o in range(n_options):
                    s = flat[lane][o]
                    sel_o = zf[s] & ~taken
                    pick = np.where(sel_o, np.int32(o), pick)
                    chosen.append((s, sel_o))
                    taken = taken | zf[s]
                for s, sel_o in chosen:
                    zf[s] = zf[s] & ~sel_o
                sel[..., lane] = pick
        z_out = np.stack(zf, axis=-1).reshape(batch + (depth, n_lanes))
        return ScheduleStepResult(sel=sel, z_out=z_out, advance=drain_count(z_out))

    schedule_step.n_lanes = n_lanes
    schedule_step.lookahead = lookahead
    schedule_step.n_options = n_options
    schedule_step.steps_table = steps_np
    schedule_step.lanes_table = lanes_np
    return schedule_step
