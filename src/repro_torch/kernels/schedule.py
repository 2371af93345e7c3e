"""The TensorDash scheduler over whole streams (new: no Pallas counterpart).

:func:`schedule_streams` runs the paper's one-side hardware scheduler
(:mod:`repro_torch.core.scheduler`) over ``S`` independent streams of
effectual bits ``z [S, T, n_lanes]`` and returns, per stream, each cycle's
mux selections ``sel [S, T, n_lanes]`` (``n_options`` = idle), its row
advance ``advance [S, T]`` and the cycle count ``n_cycles [S]``; rows past a
stream's ``n_cycles`` hold ``sel = n_options`` and ``advance = 0``.  That is
the schedule the scheduled-form codec (:mod:`repro_torch.core.compress`)
packs values by.  The JAX package runs it as one ``lax.scan`` over the rows
(``repro/core/compress.py``).

On a CPU tensor it runs the plain version, :func:`schedule_streams_ref`: a
loop of :func:`~repro_torch.core.scheduler.make_schedule_step` over the
rows, all streams at once.  On a CUDA tensor it makes one launch of
``td_schedule_kernel`` (``csrc/schedule.cu``): one thread a stream, the
window held as bit words, the connectivity tables passed in
:class:`~repro_torch.kernels._build.ScheduleArgs`.  A failed build or launch
raises.  :data:`LAUNCHES` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.scheduler import connectivity, levels, make_schedule_step
from repro_torch.kernels import block_mask

__all__ = ["schedule_streams", "schedule_streams_ref", "schedule_tables", "LAUNCHES"]

#: launches of ``td_schedule_kernel`` since :func:`reset_launch_counts`
LAUNCHES = {"td_schedule_kernel": 0}
# must match csrc/schedule.cu
_MAX_LANES = 32
_MAX_OPTIONS = 8
_MAX_LEVELS = 16


def reset_launch_counts() -> None:
    LAUNCHES["td_schedule_kernel"] = 0


def _check(z: torch.Tensor, n_lanes: int, lookahead: int) -> None:
    if lookahead not in (1, 2):
        raise ValueError(f"lookahead={lookahead}: the scheduler takes 1 or 2")
    if not 1 <= n_lanes <= _MAX_LANES:
        raise ValueError(f"n_lanes={n_lanes}: the scheduler takes 1 to {_MAX_LANES} lanes")
    if z.ndim != 3 or z.shape[2] != n_lanes:
        raise ValueError(f"z of shape {tuple(z.shape)} is not [S, T, {n_lanes}]")
    if z.shape[1] == 0:
        raise ValueError("a stream of T = 0 rows has no schedule")


@functools.lru_cache(maxsize=None)
def schedule_tables(n_lanes: int = 16, lookahead: int = 2):
    """The connectivity tables in the kernel's form: each option's row step
    and lane rotation (option ``o`` of lane ``i`` reads row ``step[o]``,
    lane ``(i + rot[o]) % n_lanes``, the same for every lane) and each
    level's lane mask, in :func:`~repro_torch.core.scheduler.levels` order.
    Raises ``ValueError`` for tables the kernel cannot take."""
    steps, lanes = connectivity(n_lanes, lookahead)
    rot = (lanes - np.arange(n_lanes)[:, None]) % n_lanes
    if not ((steps == steps[0]).all() and (rot == rot[0]).all()):
        raise ValueError("the kernel takes connectivity tables that are the same for every lane")
    masks = [sum(1 << i for i in lvl) for lvl in levels(n_lanes, lookahead)]
    if steps.shape[1] > _MAX_OPTIONS or len(masks) > _MAX_LEVELS:
        raise ValueError(f"{steps.shape[1]} options / {len(masks)} levels exceed the kernel's "
                         f"{_MAX_OPTIONS} / {_MAX_LEVELS}")
    return steps[0].tolist(), rot[0].tolist(), masks


def schedule_streams_ref(z, n_lanes: int = 16, lookahead: int = 2):
    """The plain version: one :func:`make_schedule_step` a row over all
    streams at once, on the host, as the JAX scan steps (window start
    clamped at ``T + lookahead - depth``, outputs zero once a stream's
    pointer passes ``T``).  Returns CPU tensors ``(sel int8, advance int8,
    n_cycles int32)``."""
    z = torch.as_tensor(z)
    _check(z, n_lanes, lookahead)
    zb = (z.detach() != 0).cpu().numpy()
    s, t, _ = zb.shape
    depth = lookahead + 1
    step = make_schedule_step(n_lanes, lookahead)
    n_options = step.n_options
    buf = np.concatenate([zb, np.zeros((s, lookahead, n_lanes), bool)], axis=1)
    sel = np.full((s, t, n_lanes), n_options, np.int8)
    adv = np.zeros((s, t), np.int8)
    p = np.zeros(s, np.int64)
    streams = np.arange(s)[:, None]
    for c in range(t):
        live = p < t
        if not live.any():
            break
        rows = np.minimum(p, t + lookahead - depth)[:, None] + np.arange(depth)
        res = step(buf[streams, rows])
        buf[streams, rows] = res.z_out
        sel[live, c] = res.sel[live]
        adv[live, c] = res.advance[live]
        p = p + np.where(live, res.advance, 0)
    n_cycles = (adv > 0).sum(axis=1).astype(np.int32)
    return torch.from_numpy(sel), torch.from_numpy(adv), torch.from_numpy(n_cycles)


def _launch(z: torch.Tensor, n_lanes: int, lookahead: int):
    """One launch of ``td_schedule_kernel`` on ``z``'s card."""
    from repro_torch.kernels import _build

    steps, rot, masks = schedule_tables(n_lanes, lookahead)
    s, t, _ = z.shape
    if t >= 2**31 or s * t * n_lanes >= 2**62:
        raise ValueError(f"schedule: [{s}, {t}, {n_lanes}] is too large")
    dev = z.device
    # 0/1 bytes in the [S, T, N] row-major order the kernel reads: ``z != 0``
    # keeps the strides of a permuted operand (``compress(x.T)``)
    zb = (z != 0).contiguous().view(torch.uint8)
    n_options = len(steps)
    sel = torch.full((s, t, n_lanes), n_options, dtype=torch.int8, device=dev)
    adv = torch.zeros((s, t), dtype=torch.int8, device=dev)
    n_cycles = torch.empty((s,), dtype=torch.int32, device=dev)  # every entry written
    args = _build.ScheduleArgs(
        z=zb.data_ptr(), sel=sel.data_ptr(), advance=adv.data_ptr(), n_cycles=n_cycles.data_ptr(),
        T=t, S=s, N=n_lanes, depth=lookahead + 1, n_options=n_options, n_levels=len(masks),
        vec=int(n_lanes % 4 == 0 and zb.data_ptr() % 4 == 0 and sel.data_ptr() % 4 == 0),
    )
    for o in range(n_options):
        args.opt_step[o], args.opt_rot[o] = steps[o], rot[o]
    for i, m in enumerate(masks):
        args.level_mask[i] = m
    stream, current = block_mask._card_stream(dev)
    lib = _build.library()
    with current:
        rc = lib.td_schedule(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"td_schedule_kernel: CUDA launch failed with cudaError {rc}")
    LAUNCHES["td_schedule_kernel"] += 1
    return sel, adv, n_cycles


def schedule_streams(z: torch.Tensor, *, n_lanes: int = 16, lookahead: int = 2):
    """The schedule of each stream of ``z [S, T, n_lanes]`` (nonzero =
    effectual): ``(sel int8 [S, T, n_lanes], advance int8 [S, T], n_cycles
    int32 [S])`` on ``z``'s device.  ``n_lanes`` up to 32, ``lookahead`` 1
    or 2; anything else raises ``ValueError``."""
    _check(z, n_lanes, lookahead)
    if not block_mask.on_card(z):
        return schedule_streams_ref(z, n_lanes, lookahead)
    return _launch(z, n_lanes, lookahead)
