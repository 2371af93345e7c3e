"""TensorDash processing-element and tile stream simulators (port of
``repro/core/pe.py``, in numpy).

A PE performs ``n_lanes`` MACs per cycle.  The dense baseline needs ``T``
cycles for a stream of ``T`` rows; TensorDash consumes the stream through a
``lookahead+1``-deep staging window, draining ``AS in [1, depth]`` rows per
cycle, so ``speedup <= depth``.

* :func:`simulate_stream` — one PE, one effectual-pair mask stream.
* :func:`simulate_tile` — R rows in lockstep sharing the window pointer
  (paper section 3.3): the tile advances at the minimum drain across rows.

Both take leading batch dimensions (independent streams or tiles, each with
its own window pointer) and give the JAX model's cycle counts exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.scheduler import make_schedule_step

__all__ = ["effectual_mask", "simulate_stream", "simulate_tile", "dense_cycles"]


def effectual_mask(b_nonzero, a_nonzero=None):
    """Z vector stream: a pair is effectual iff the extracted side(s) are
    nonzero.  One-side extraction (the paper's training configuration)
    passes only ``b_nonzero``; two-side extraction ANDs both masks.  Works
    on numpy arrays and torch tensors alike."""
    if a_nonzero is None:
        return b_nonzero
    return b_nonzero & a_nonzero


def dense_cycles(t: int) -> int:
    """Baseline cycles for a T-row stream (one row of n_lanes MACs / cycle)."""
    return t


class StreamSimResult(NamedTuple):
    cycles: np.ndarray  # int32: TensorDash cycles to consume the stream(s)
    dense: np.ndarray  # int32: baseline cycles (= T)


def _lockstep_cycles(z: np.ndarray, n_lanes: int, lookahead: int) -> np.ndarray:
    """Cycles of ``z [G, R, T, n_lanes]``: G independent tiles of R rows.
    Each cycle schedules every row's window, drains the tile by the minimum
    advance, and counts until the pointer passes T (the JAX scan's clamped
    window and gated counter, with the finished tail skipped)."""
    g, r, t, _ = z.shape
    depth = lookahead + 1
    step = make_schedule_step(n_lanes, lookahead)
    buf = np.zeros((g, t + lookahead, r, n_lanes), bool)
    buf[:, :t] = np.swapaxes(z, 1, 2)
    p = np.zeros(g, np.int64)
    cycles = np.zeros(g, np.int32)
    done = np.full(g, t <= 0)
    gi = np.arange(g)[:, None]
    offs = np.arange(depth)
    for _ in range(t):
        if done.all():
            break
        rows = np.minimum(p, t + lookahead - depth)[:, None] + offs  # [G, depth]
        res = step(np.swapaxes(buf[gi, rows], 1, 2))  # [G, R, depth, L]
        buf[gi, rows] = np.swapaxes(res.z_out, 1, 2)
        cycles += np.where(done, 0, 1).astype(np.int32)
        p = p + res.advance.min(axis=1)
        done = p >= t
    return cycles


def simulate_tile(z_rows, *, n_lanes: int = 16, lookahead: int = 2) -> StreamSimResult:
    """Lockstep tile simulation of ``z_rows [..., R, T, n_lanes]`` effectual
    masks: each row schedules its own sparse stream, the tile drains the
    shared window at ``min_r AS_r``."""
    z = np.asarray(z_rows, dtype=bool)
    batch, (r, t, l) = z.shape[:-3], z.shape[-3:]
    cycles = _lockstep_cycles(z.reshape((-1, r, t, l)), n_lanes, lookahead)
    return StreamSimResult(cycles=cycles.reshape(batch), dense=np.int32(t))


def simulate_stream(z, *, n_lanes: int = 16, lookahead: int = 2) -> StreamSimResult:
    """Cycle count for one PE consuming ``z [..., T, n_lanes]``; never
    slower than dense (AS >= 1)."""
    z = np.asarray(z, dtype=bool)
    return simulate_tile(z[..., None, :, :], n_lanes=n_lanes, lookahead=lookahead)
