"""Scheduled-form (value, idx) compression codec — paper sections 3.6/3.7
(port of ``repro/core/compress.py``).

TensorDash's scheduler doubles as a compression engine: a dense stream of
``[T, n_lanes]`` values is consumed by the (one-side) scheduler in
``C <= T`` cycles; storing the ``C`` packed rows together with the per-lane
mux selections (``sel``, the MS signal, 3 bits a lane) and the per-cycle row
advance (AS, 2 bits) is a lossless encoding of the dense tensor.  The
decompressor (Fig. 12 of the paper) is the mirror of the mux stage: each
packed value is scattered back to its original (step, lane) position.

The schedule is the one serial part: :func:`compress` and
:func:`simulate_macs` take it from
:func:`~repro_torch.kernels.schedule.schedule_streams` (the
``td_schedule_kernel`` on a CUDA tensor, a host loop of the scheduler step
on a CPU tensor).  Everything else runs on the tensor's device without a
loop: cycle ``c`` reads the rows from ``p_c``, the exclusive cumulative sum
of ``advance``, so the values are one gather (:func:`compress`), the
decompressor one scatter (:func:`decompress`) and the MAC datapath one
product and sum (:func:`simulate_macs`).  Outputs equal the JAX package's
bit for bit on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.scheduler import connectivity
from repro_torch.kernels import schedule as _schedule  # a module: kernels.schedule imports core

__all__ = ["Scheduled", "compress", "decompress", "simulate_macs"]


class Scheduled(NamedTuple):
    """Scheduled-form tensor.  Rows beyond ``n_cycles`` are zero padding."""

    values: torch.Tensor  # [T, n_lanes] packed values (only first n_cycles valid)
    sel: torch.Tensor  # [T, n_lanes] int32 mux selections; == n_options -> idle
    advance: torch.Tensor  # [T] int32 AS per cycle
    n_cycles: torch.Tensor  # int32 scalar: number of valid packed rows


def _tables(n_lanes: int, lookahead: int, device):
    steps, lanes = connectivity(n_lanes, lookahead)
    return (torch.as_tensor(steps, device=device, dtype=torch.int64),
            torch.as_tensor(lanes, device=device, dtype=torch.int64), steps.shape[1])


def _sources(sel: torch.Tensor, advance: torch.Tensor, n_lanes: int, lookahead: int):
    """Per cycle and lane of a schedule ``sel [..., C, n_lanes]``,
    ``advance [..., C]``: whether the lane holds a value, and the (row,
    lane) of the dense stream it came from (row ``p_c + step``)."""
    steps_t, lanes_t, n_options = _tables(n_lanes, lookahead, sel.device)
    sel = sel.long()
    valid = sel < n_options
    pick = sel.clamp(max=n_options - 1)
    lane_ids = torch.arange(n_lanes, device=sel.device)
    p = torch.cumsum(advance.long(), dim=-1) - advance.long()  # row of each cycle's window
    return valid, p.unsqueeze(-1) + steps_t[lane_ids, pick], lanes_t[lane_ids, pick]


def _check_stream(x: torch.Tensor, n_lanes: int, what: str) -> None:
    if x.ndim < 2 or x.shape[-1] != n_lanes:
        raise ValueError(f"{what} of shape {tuple(x.shape)} is not [..., T, {n_lanes}]")
    if x.shape[-2] == 0:
        raise ValueError(f"{what}: a stream of T = 0 rows has no schedule")


def compress(x: torch.Tensor, *, n_lanes: int = 16, lookahead: int = 2) -> Scheduled:
    """One-side schedule of ``x [T, n_lanes]`` into scheduled form, on
    ``x``'s device."""
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"x of shape {tuple(x.shape)} is not [T, {n_lanes}]")
    _check_stream(x, n_lanes, "x")
    t = x.shape[0]
    sel, adv, n_cycles = _schedule.schedule_streams(x.unsqueeze(0), n_lanes=n_lanes, lookahead=lookahead)
    sel, adv = sel[0], adv[0]
    valid, rows, cols = _sources(sel, adv, n_lanes, lookahead)
    # past n_cycles every lane is idle, so only emitted cycles gather
    src = x[rows.clamp(0, t - 1), cols]
    values = torch.where(valid & (rows < t), src, torch.zeros((), dtype=x.dtype, device=x.device))
    return Scheduled(values=values, sel=sel.int(), advance=adv.int(), n_cycles=n_cycles[0])


def decompress(s: Scheduled, *, t: int, n_lanes: int = 16, lookahead: int = 2) -> torch.Tensor:
    """Fig. 12 decompressor: scheduled form back to dense ``[t, n_lanes]``
    (one scatter; lanes marked idle are dropped), on the values' device."""
    vals = torch.as_tensor(s.values)
    valid, rows, cols = _sources(torch.as_tensor(s.sel, device=vals.device),
                                 torch.as_tensor(s.advance, device=vals.device), n_lanes, lookahead)
    keep = valid & (rows < t + lookahead)  # JAX's mode="drop" scatter
    buf = torch.zeros((t + lookahead) * n_lanes, dtype=vals.dtype, device=vals.device)
    buf[(rows * n_lanes + cols)[keep]] = vals[keep]
    return buf.view(t + lookahead, n_lanes)[:t]


def simulate_macs(a: torch.Tensor, b: torch.Tensor, *, n_lanes: int = 16, lookahead: int = 2,
                  two_side: bool = True):
    """Functional simulation of the TensorDash PE MAC datapath.

    Consumes value streams ``a, b [..., T, n_lanes]`` (leading dims: streams
    scheduled independently) through the scheduler, both operands moving
    in tandem through the same mux selections as in the hardware, and
    returns ``(accumulator, cycles)``.  The effectual pairs are ``a != 0 &
    b != 0`` (``two_side``) or ``b != 0``.  Each cycle's lane products are
    summed in fp32 (fp64 for fp64 operands), then the cycles: one after
    another on the CPU, as the JAX model's scan sums them (so the two agree
    bit for bit), in one parallel sum on the card.  The result is ``sum(a *
    b)`` up to that rounding — TensorDash only elides multiplications by
    zero."""
    a, b = torch.as_tensor(a), torch.as_tensor(b, device=torch.as_tensor(a).device)
    _check_stream(a, n_lanes, "a")
    if b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    lead, t = a.shape[:-2], a.shape[-2]
    a3, b3 = a.reshape(-1, t, n_lanes), b.reshape(-1, t, n_lanes)
    z = (a3 != 0) & (b3 != 0) if two_side else b3 != 0
    sel, adv, n_cycles = _schedule.schedule_streams(z, n_lanes=n_lanes, lookahead=lookahead)
    valid, rows, cols = _sources(sel, adv, n_lanes, lookahead)
    valid = valid & (rows < t)  # the padding rows hold zeros
    stream = torch.arange(a3.shape[0], device=a.device)[:, None, None]
    rows = rows.clamp(0, t - 1)
    acc_dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    zero = torch.zeros((), dtype=acc_dtype, device=a.device)
    av = torch.where(valid, a3[stream, rows, cols].to(acc_dtype), zero)
    bv = torch.where(valid, b3[stream, rows, cols].to(acc_dtype), zero)
    per_cycle = _halving_sum(av * bv)
    if per_cycle.device.type == "cpu":  # the JAX scan's order: cycle after cycle
        acc = torch.zeros(per_cycle.shape[:-1], dtype=acc_dtype)
        for c in range(per_cycle.shape[-1]):
            acc = acc + per_cycle[..., c]
    else:  # one parallel sum on the card
        acc = per_cycle.sum(dim=-1)
    return acc.reshape(lead), n_cycles.reshape(lead)


def _halving_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by halving (first half plus second half, an odd
    element carried): the order XLA's CPU reduction takes over a cycle's
    lanes, so the fp32 sums equal the JAX model's on the CPU."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = torch.cat([p[..., :h] + p[..., h:2 * h], p[..., 2 * h:]], dim=-1)
    return p[..., 0]
