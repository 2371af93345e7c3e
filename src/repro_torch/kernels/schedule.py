"""The TensorDash scheduler over whole streams and lockstep tiles (new: no
Pallas counterpart).

:func:`schedule_streams` runs the paper's one-side hardware scheduler
(:mod:`repro_torch.core.scheduler`) over ``S`` independent streams of
effectual bits ``z [S, T, n_lanes]`` and returns, per stream, each cycle's
mux selections ``sel [S, T, n_lanes]`` (``n_options`` = idle), its row
advance ``advance [S, T]`` and the cycle count ``n_cycles [S]``; rows past a
stream's ``n_cycles`` hold ``sel = n_options`` and ``advance = 0``.  That is
the schedule the scheduled-form codec (:mod:`repro_torch.core.compress`)
packs values by.  The JAX package runs it as one ``lax.scan`` over the rows
(``repro/core/compress.py``).

:func:`tile_cycles` is the paper's cycle model (``repro/core/pe.py``'s
``simulate_tile``, a ``lax.scan`` vmapped over groups): ``R`` rows of a tile
each schedule their own stream and the tile drains its shared window at the
minimum advance over its rows.  It takes a ragged batch, each tile its own
``T``, packed by :func:`pack_tiles` into one buffer.

On a CPU tensor each runs its plain version (:func:`schedule_streams_ref`,
:func:`tile_cycles_ref`): loops of
:func:`~repro_torch.core.scheduler.make_schedule_step` over the rows.  On a
CUDA tensor :func:`schedule_streams` launches ``td_schedule_kernel``
(``csrc/schedule.cu``): one thread a stream, or, for a few long streams
(:func:`split_geometry`), one thread a segment in four launches whose
algorithm :func:`schedule_streams_split_ref` re-enacts on the host; and
:func:`tile_cycles` makes one launch of ``td_tile_kernel``, a warp walking
one tile or a few (:func:`tile_launch_shape`) on rows staged in shared
memory.  A failed build
or launch raises.  :data:`LAUNCHES` counts the wrapper calls that launched.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.scheduler import connectivity, levels, make_schedule_step
from repro_torch.kernels import block_mask

__all__ = ["schedule_streams", "schedule_streams_ref", "schedule_streams_split_ref", "schedule_tables",
           "split_geometry", "tile_cycles", "tile_cycles_ref", "tile_launch_shape", "pack_tiles", "tile_views",
           "LAUNCHES"]

#: calls of ``td_schedule_kernel`` (a split schedule's four launches count
#: once) and of ``td_tile_kernel`` since :func:`reset_launch_counts`
LAUNCHES = {"td_schedule_kernel": 0, "td_tile_kernel": 0}
# must match csrc/schedule.cu
_MAX_LANES = 32
_MAX_OPTIONS = 8
_MAX_LEVELS = 16
_MAX_SEGS = 2048  # segments a stream
_MAX_TILE_ROWS = 1024  # rows a tile on the card (a CTA)
_MAX_T = 0x7FFFFFF0  # rows a stream on the card
_TILE_SMEM = 227 * 1024 - 64  # shared bytes of a tile launch's CTA
#: the split: segments of about SEG_ROWS rows, at most SPLIT_BUDGET segments a
#: launch, OVERLAP head rows; a launch splits when that makes at least MIN_SEGS a stream
SEG_ROWS, SPLIT_BUDGET, OVERLAP, MIN_SEGS = 1024, 4096, 512, 8
#: the tile launch packs tiles into a warp until it has at most this many warps a SM (one a scheduler)
TILE_WARPS_PER_SM = 4


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tables(n_lanes: int, lookahead: int) -> None:
    if lookahead not in (1, 2):
        raise ValueError(f"lookahead={lookahead}: the scheduler takes 1 or 2")
    if not 1 <= n_lanes <= _MAX_LANES:
        raise ValueError(f"n_lanes={n_lanes}: the scheduler takes 1 to {_MAX_LANES} lanes")


def _check(z: torch.Tensor, n_lanes: int, lookahead: int) -> None:
    _check_tables(n_lanes, lookahead)
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


def _fill_tables(args, n_lanes: int, lookahead: int) -> None:
    steps, rot, masks = schedule_tables(n_lanes, lookahead)
    args.N, args.depth, args.n_options, args.n_levels = n_lanes, lookahead + 1, len(steps), len(masks)
    for o in range(len(steps)):
        args.opt_step[o], args.opt_rot[o] = steps[o], rot[o]
    for i, m in enumerate(masks):
        args.level_mask[i] = m


# ---------------------------------------------------------------------------
# streams


def split_geometry(s: int, t: int):
    """``(n_segs, seg_rows, overlap)`` of the split a launch of ``s``
    streams of ``t`` rows takes on the card, or ``None``: one thread a
    stream.  A launch splits when it has few streams (at most
    ``SPLIT_BUDGET / MIN_SEGS``) and they are long (``MIN_SEGS`` segments of
    about ``SEG_ROWS`` rows a stream, at most ``SPLIT_BUDGET`` segments in
    all and 2048 a stream)."""
    k = min(_MAX_SEGS, SPLIT_BUDGET // s, -(-t // SEG_ROWS))
    if k < MIN_SEGS or t > _MAX_T:
        return None
    seg = -(-t // k)
    return -(-t // seg), seg, min(OVERLAP, seg // 2)


def split_bytes(segs: int, overlap: int) -> int:
    """The split's workspace: a 16-byte record per head row, 64 bytes a
    segment (its resume state, its hand-over and its plan)."""
    return segs * (16 * overlap + 64)


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


def _cycle(step, buf: np.ndarray, p: np.ndarray, w: np.ndarray):
    """One scheduler cycle of each window ``w [m, depth, N]`` at rows ``p``
    of ``buf`` (the stream, zero past its end): ``(sel, advance, the
    windows after)``; the rows the windows shift in come from ``buf``."""
    res = step(w)
    a = res.advance.astype(np.int64)
    depth, m = w.shape[1], np.arange(len(p))
    after = np.empty_like(w)
    for d in range(depth):
        old = d + a  # the old window's row, while inside it
        after[:, d] = np.where((old < depth)[:, None], res.z_out[m, np.minimum(old, depth - 1)], buf[p + old])
    return res.sel, a, after


def schedule_streams_split_ref(z, seg_rows: int, overlap: int, n_lanes: int = 16, lookahead: int = 2, *,
                               chains: list | None = None):
    """The split schedule of ``csrc/schedule.cu`` on the host, the same
    four passes over each stream cut into segments of ``seg_rows`` rows with
    heads of ``overlap`` rows: (1) each segment starts fresh at its first
    row and records its state (window bits, cycle count) at each head row
    it visits; (2) it runs on until its state at a row equals a later
    segment's head record there (or to the end: the sequential walk);
    (3) the chain of hand-overs from segment 0 gives each segment on it its
    cycles and output offset; (4) each runs again from its entry state and
    writes its cycles.  Returns what :func:`schedule_streams_ref` returns,
    bit for bit; ``chains``, when given, receives each stream's chain of
    ``(segment, entry row, cycles, output offset)``."""
    z = torch.as_tensor(z)
    _check(z, n_lanes, lookahead)
    if not (seg_rows >= 2 and 1 <= overlap <= seg_rows // 2):
        raise ValueError(f"split of {seg_rows} rows a segment with {overlap} head rows: want 1 <= overlap "
                         "<= seg_rows / 2")
    zb = (z.detach() != 0).cpu().numpy()
    s, t, _ = zb.shape
    depth = lookahead + 1
    step = make_schedule_step(n_lanes, lookahead)
    k = -(-t // seg_rows)
    starts = np.arange(k) * seg_rows
    sel = np.full((s, t, n_lanes), step.n_options, np.int8)
    adv = np.zeros((s, t), np.int8)
    n_cycles = np.zeros(s, np.int32)
    for i in range(s):
        buf = np.concatenate([zb[i], np.zeros((2 * depth, n_lanes), bool)])
        # (1) heads: (segment, row) -> (cycles, window) at each head row visited
        head: dict = {}
        p, c = starts.copy(), np.zeros(k, np.int64)
        w = buf[starts[:, None] + np.arange(depth)]
        stop = np.minimum(starts + overlap, t)
        while (live := np.nonzero(p < stop)[0]).size:
            for j in live:
                head[(j, p[j])] = (c[j], w[j].copy())
            _, a, w[live] = _cycle(step, buf, p[live], w[live])
            p[live] += a
            c[live] += 1
        # (2) on from there until a later segment's head is in the same state
        ends = {}
        while True:
            for j in np.nonzero(p < t)[0]:
                if j in ends:
                    continue
                nxt = p[j] // seg_rows
                if nxt > j and p[j] - starts[nxt] < overlap:
                    hc, hw = head[(nxt, p[j])] if (nxt, p[j]) in head else (None, None)
                    if hc is not None and np.array_equal(hw, w[j]):
                        ends[j] = (nxt, p[j], c[j], hc)
            live = np.array([j for j in range(k) if p[j] < t and j not in ends], np.int64)
            if not live.size:
                break
            _, a, w[live] = _cycle(step, buf, p[live], w[live])
            p[live] += a
            c[live] += 1
        for j in range(k):
            ends.setdefault(j, (k, t, c[j], 0))
        # (3) the chain from segment 0: entry row, cycles, output offset
        chain, j, entry, c_entry, out = [], 0, 0, 0, 0
        while True:
            nj, q, c_end, c_enter = ends[j]
            chain.append((j, entry, c_end - c_entry, out))
            out += c_end - c_entry
            if nj >= k:
                break
            j, entry, c_entry = nj, q, c_enter
        n_cycles[i] = out
        if chains is not None:
            chains.append([tuple(int(x) for x in link) for link in chain])
        # (4) each chain segment again from its entry state, writing its cycles
        p = np.array([e for _, e, _, _ in chain], np.int64)
        w = np.stack([head[(j, e)][1] for j, e, _, _ in chain])
        todo = np.array([n for _, _, n, _ in chain])
        at = np.array([o for _, _, _, o in chain])
        for cyc in range(int(todo.max())):
            live = np.nonzero(todo > cyc)[0]
            sl, a, w[live] = _cycle(step, buf, p[live], w[live])
            sel[i, at[live] + cyc] = sl
            adv[i, at[live] + cyc] = a
            p[live] += a
    return torch.from_numpy(sel), torch.from_numpy(adv), torch.from_numpy(n_cycles)


def _launch(z: torch.Tensor, n_lanes: int, lookahead: int, split):
    """One ``td_schedule`` call on ``z``'s card: one thread a stream
    (``split`` None) or the split ``(n_segs, seg_rows, overlap)``."""
    from repro_torch.kernels import _build

    s, t, _ = z.shape
    if t > _MAX_T or s * t * n_lanes >= 2**62:
        raise ValueError(f"schedule: [{s}, {t}, {n_lanes}] is too large")
    dev = z.device
    # 0/1 bytes in the [S, T, N] row-major order the kernel reads: ``z != 0``
    # keeps the strides of a permuted operand (``compress(x.T)``); a bool
    # tensor's bytes are its 0/1 already
    zb = (z if z.dtype == torch.bool else z != 0).contiguous().view(torch.uint8)
    n_options = len(schedule_tables(n_lanes, lookahead)[0])
    sel = torch.full((s, t, n_lanes), n_options, dtype=torch.int8, device=dev)
    adv = torch.zeros((s, t), dtype=torch.int8, device=dev)
    n_cycles = torch.empty((s,), dtype=torch.int32, device=dev)  # every entry written
    n_segs, seg_rows, overlap = split or (0, 0, 0)
    work = torch.empty((split_bytes(s * n_segs, overlap),), dtype=torch.uint8, device=dev) if split else None
    args = _build.ScheduleArgs(
        z=zb.data_ptr(), sel=sel.data_ptr(), advance=adv.data_ptr(), n_cycles=n_cycles.data_ptr(),
        work=work.data_ptr() if split else None, T=t, S=s,
        vec=int(n_lanes % 4 == 0 and zb.data_ptr() % 4 == 0 and sel.data_ptr() % 4 == 0),
        n_segs=n_segs, seg_rows=seg_rows, overlap=overlap,
    )
    _fill_tables(args, n_lanes, lookahead)
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
    return _launch(z, n_lanes, lookahead, split_geometry(z.shape[0], z.shape[1]))


# ---------------------------------------------------------------------------
# tiles


def tile_cycles_ref(z: np.ndarray, n_lanes: int, lookahead: int) -> np.ndarray:
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


def _header_bytes(g: int) -> int:
    return -(-12 * g // 16) * 16


def pack_tiles(parts) -> torch.Tensor:
    """One uint8 buffer holding a ragged batch of tiles, on the parts'
    device: tile offsets (int64 ``[G]``, bytes from the data's start), each
    tile's ``T`` (int32 ``[G]``), then the tiles' 0/1 bytes, tile ``g``'s
    ``[R, T_g, N]`` rows at a multiple of 16.  ``parts`` are tensors ``[G_i,
    R, T_i, N]`` of one ``R`` and ``N``; :func:`tile_views` cuts the buffer."""
    offsets, ts, chunks, pos = [], [], [], 0
    for z in parts:
        g, r, t, n = z.shape
        size = r * t * n
        padded = size + (-size % 16)
        zb = (z != 0).reshape(g, size).to(torch.uint8)
        if padded != size:
            zb = torch.cat([zb, zb.new_zeros((g, padded - size))], dim=1)
        offsets.append(pos + padded * np.arange(g, dtype=np.int64))
        ts.append(np.full(g, t, np.int32))
        chunks.append(zb.reshape(-1))
        pos += g * padded
    g = sum(len(o) for o in offsets)
    head = np.zeros(_header_bytes(g), np.uint8)
    if g:
        head[:8 * g] = np.concatenate(offsets).view(np.uint8)
        head[8 * g:12 * g] = np.concatenate(ts).view(np.uint8)
    return torch.cat([torch.from_numpy(head).to(parts[0].device), *chunks])


def tile_views(packed: torch.Tensor, n_tiles: int):
    """``(z, t, offset)`` views of a :func:`pack_tiles` buffer."""
    h = _header_bytes(n_tiles)
    return (packed[h:], packed[8 * n_tiles:12 * n_tiles].view(torch.int32),
            packed[:8 * n_tiles].view(torch.int64))


def tile_launch_shape(g: int, t: int | None, rows: int, sms: int) -> tuple[int, int]:
    """``(pack, stage_words)`` of a ``td_tile`` launch of ``g`` tiles of
    ``rows`` PE rows, at most ``t`` rows each (``None``: not known), on a
    card of ``sms`` SMs.  At ``rows <= 32`` a one-warp CTA walks ``pack``
    tiles (at most ``32 // rows``), the fewest that keep the launch within
    ``TILE_WARPS_PER_SM`` warps a SM: a cycle's cost is its warp's
    instructions, and warps that share a scheduler slow each other, while a
    warp stages all its tiles' rows before its first cycle.  A tile's rows
    are staged as ``rows * (t | 1)`` shared words where ``pack`` of them fit
    in a CTA (else 0: each row is loaded when a cycle needs it; so is any
    tile longer than ``t``).  Wide tiles (``rows > 32``, a CTA a tile):
    ``(1, 0)``."""
    if rows > 32:
        return 1, 0
    pack = min(32 // rows, max(1, -(-g // (TILE_WARPS_PER_SM * sms))))
    words = rows * (t | 1) if t else 0
    return pack, words if 4 * pack * words <= _TILE_SMEM else 0


def _tile_launch(z, t, offset, rows: int, n_lanes: int, lookahead: int, shape) -> torch.Tensor:
    """One ``td_tile`` launch on ``z``'s card at the launch shape ``shape``
    (:func:`tile_launch_shape`)."""
    from repro_torch.kernels import _build

    if rows > _MAX_TILE_ROWS:
        raise ValueError(f"rows={rows}: a tile on the card takes at most {_MAX_TILE_ROWS} rows")
    g = t.shape[0]
    cycles = torch.empty((g,), dtype=torch.int32, device=z.device)  # every entry written
    if z.data_ptr() % 16:
        raise ValueError("tile_cycles: the tiles' bytes must start 16-byte aligned (pack_tiles)")
    pack, words = shape
    args = _build.TileArgs(z=z.data_ptr(), offset=offset.data_ptr(), t=t.data_ptr(), cycles=cycles.data_ptr(),
                           G=g, R=rows, pack=pack, stage_words=words)
    _fill_tables(args, n_lanes, lookahead)
    stream, current = block_mask._card_stream(z.device)
    lib = _build.library()
    with current:
        rc = lib.td_tile(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"td_tile_kernel: CUDA launch failed with cudaError {rc}")
    LAUNCHES["td_tile_kernel"] += 1
    return cycles


def tile_cycles(z: torch.Tensor, t: torch.Tensor, offset: torch.Tensor, *, rows: int, n_lanes: int = 16,
                lookahead: int = 2, max_t: int | None = None) -> torch.Tensor:
    """Lockstep cycles (int32 ``[G]``, on ``z``'s device) of a ragged batch
    of tiles of ``rows`` PE rows: tile ``g``'s 0/1 bytes ``[rows, t[g],
    n_lanes]`` at ``z[offset[g]:]`` (:func:`pack_tiles`, :func:`tile_views`).
    ``max_t``, the longest ``t[g]`` as the caller knows it, sizes the card's
    staging (:func:`tile_launch_shape`; ``None``: rows loaded as needed);
    the cycles do not depend on it.  ``n_lanes`` up
    to 32, ``lookahead`` 1 or 2, on the card at most 1024 rows; anything
    else raises ``ValueError``."""
    _check_tables(n_lanes, lookahead)
    if rows < 1 or t.shape != offset.shape or t.ndim != 1:
        raise ValueError(f"tile_cycles: rows={rows}, t {tuple(t.shape)}, offset {tuple(offset.shape)}")
    if block_mask.on_card(z):
        shape = tile_launch_shape(t.shape[0], max_t, rows, block_mask.sm_count(z.device))
        return _tile_launch(z, t, offset, rows, n_lanes, lookahead, shape)
    zb, tn, on = z.numpy(), t.numpy(), offset.numpy()
    cycles = np.zeros(tn.shape[0], np.int32)
    for tt in np.unique(tn):
        idx = np.nonzero(tn == tt)[0]
        size = rows * int(tt) * n_lanes
        tiles = np.stack([zb[o:o + size] for o in on[idx]]).reshape(len(idx), rows, int(tt), n_lanes) != 0
        cycles[idx] = tile_cycles_ref(tiles, n_lanes, lookahead)
    return torch.from_numpy(cycles)
