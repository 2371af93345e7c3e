"""TensorDash processing-element and tile stream simulators (port of
``repro/core/pe.py``).

A PE performs ``n_lanes`` MACs per cycle.  The dense baseline needs ``T``
cycles for a stream of ``T`` rows; TensorDash consumes the stream through a
``lookahead+1``-deep staging window, draining ``AS in [1, depth]`` rows per
cycle, so ``speedup <= depth``.

* :func:`simulate_stream` — one PE, one effectual-pair mask stream.
* :func:`simulate_tile` — R rows in lockstep sharing the window pointer
  (paper section 3.3): the tile advances at the minimum drain across rows.
* :func:`simulate_tiles` — a ragged batch of tiles (each its own ``T``) in
  one launch: the perf model's convolutions.

They run where a torch tensor lives; numpy input goes to ``device``, the
card unless the caller asks for the CPU (as JAX puts numpy input on its
default device).  On the card the cycles come from the tile kernel
(:func:`repro_torch.kernels.schedule.tile_cycles`); on the CPU from its
plain loop.  Both give the JAX model's cycle counts exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import schedule as _schedule  # a module: kernels.schedule imports core

__all__ = ["effectual_mask", "simulate_stream", "simulate_tile", "simulate_tiles", "dense_cycles"]


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
    cycles: np.ndarray | torch.Tensor  # int32: TensorDash cycles to consume the stream(s)
    dense: np.ndarray  # int32: baseline cycles (= T)


def card_device(device=None) -> torch.device:
    """``device``, the card when it is None; raises when that is a CUDA
    device and no card is visible (nothing falls back to the host)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the cycle model runs on the card unless asked for the CPU, and no CUDA card is "
                           "visible: pass device='cpu' to run it on the host")
    return dev


def simulate_tiles(parts, *, n_lanes: int = 16, lookahead: int = 2, device=None) -> list:
    """Lockstep cycles of each tile of ``parts``, effectual masks ``[G_i, R,
    T_i, n_lanes]`` of one ``R``: one transfer (numpy input) and one tile
    launch for all of them.  Torch tensors run on their device and give
    int32 tensors there; numpy arrays run on ``device`` and give int32
    arrays."""
    host = not torch.is_tensor(parts[0])
    tensors = [torch.from_numpy(np.asarray(z, dtype=bool)) if host else z for z in parts]
    dev = card_device(device) if host else tensors[0].device
    rows = tensors[0].shape[1]
    packed = _schedule.pack_tiles(tensors).to(dev)
    counts = [z.shape[0] for z in tensors]
    z, t, offset = _schedule.tile_views(packed, sum(counts))
    cycles = _schedule.tile_cycles(z, t, offset, rows=rows, n_lanes=n_lanes, lookahead=lookahead,
                                   max_t=max(z.shape[2] for z in tensors))
    if host:
        cycles = cycles.cpu().numpy()
        return np.split(cycles, np.cumsum(counts)[:-1])
    return list(torch.split(cycles, counts))


def simulate_tile(z_rows, *, n_lanes: int = 16, lookahead: int = 2, device=None) -> StreamSimResult:
    """Lockstep tile simulation of ``z_rows [..., R, T, n_lanes]`` effectual
    masks: each row schedules its own sparse stream, the tile drains the
    shared window at ``min_r AS_r``."""
    z_rows = z_rows if torch.is_tensor(z_rows) else np.asarray(z_rows, dtype=bool)
    batch, (r, t, l) = tuple(z_rows.shape[:-3]), tuple(z_rows.shape[-3:])
    (cycles,) = simulate_tiles([z_rows.reshape((-1, r, t, l))], n_lanes=n_lanes, lookahead=lookahead,
                               device=device)
    return StreamSimResult(cycles=cycles.reshape(batch), dense=np.int32(t))


def simulate_stream(z, *, n_lanes: int = 16, lookahead: int = 2, device=None) -> StreamSimResult:
    """Cycle count for one PE consuming ``z [..., T, n_lanes]``; never
    slower than dense (AS >= 1)."""
    z = z if torch.is_tensor(z) else np.asarray(z, dtype=bool)
    return simulate_tile(z[..., None, :, :], n_lanes=n_lanes, lookahead=lookahead, device=device)
