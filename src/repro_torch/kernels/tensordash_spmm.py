"""TensorDash planned block-sparse matmul on Hopper (port of
``repro/kernels/tensordash_spmm.py``).

A plan is ``(nnz [Mb], idx [Mb, Kb])``, each block row's effectual K blocks
ascending (the tail repeats the last one), and its CSR work queue
``(row_starts [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])``, all int32 and
equal to the JAX package's arrays.  :func:`plan_blocks_csr` (from an
operand's values), :func:`plan_from_mask_csr` (from an emitted mask) and
:func:`transpose_plan_csr` (from a forward plan) build it in one launch of
the planner kernel (:func:`~repro_torch.kernels.block_mask.launch_planner`)
on a CUDA tensor, and with the torch chains of :mod:`.ref` on a CPU tensor.

The two wrappers run the CUDA kernels of ``csrc/tensordash_spmm.cu``:

* :func:`tensordash_matmul_planned` — ``C = A @ B`` over the plan
  (replaces the Pallas ``_ragged_kernel`` and, for ``compact_grid``
  ``"v2"``/``"v1"``, ``_kernel``);
* :func:`tensordash_matmul_fused` — the same plus the fp32 epilogue
  ``act(acc + bias) + residual`` and the emitted int8 ``[Mb, Nb]`` output
  block-nonzero mask (replaces ``_ragged_fused_kernel`` and
  ``_fused_kernel``).

:func:`tensordash_matmul` plans ``a`` at run time (one planner launch) and
runs the planned wrapper on that plan.

``"ragged"`` walks the plan's CSR work queue; ``"v2"``/``"v1"`` read
``idx[m, k]`` directly over a K bound of ``max(max(nnz), 1)`` (reduced on
the card, never read on the host) or ``Kb``.  The three families give
bit-identical results.  The output is written in the operands' dtype, in
bfloat16 from float32 operands, or in float32 from bfloat16 operands.  On a CPU tensor a wrapper runs the plain executor
of :mod:`.ref`; on a CUDA tensor it makes exactly one kernel launch (split-K
reduced in the same launch; :func:`kernel_tile` and :func:`kernel_splits`
give its tile and split count from the shapes) or raises.
:func:`launch_counts` counts the launches per wrapper and grid family and
per planner mode.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Literal, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import block_mask, ref

__all__ = [
    "COMPACT_GRID_MODES",
    "FUSED_ACTIVATIONS",
    "plan_blocks",
    "plan_blocks_csr",
    "plan_to_mask",
    "plan_from_mask",
    "plan_from_mask_csr",
    "plan_workqueue",
    "transpose_plan",
    "transpose_plan_csr",
    "dense_plan",
    "dense_plan_csr",
    "planned_grid_steps",
    "tensordash_matmul",
    "tensordash_matmul_planned",
    "tensordash_matmul_fused",
    "launch_counts",
    "reset_launch_counts",
]

#: epilogue activations the fused kernel understands
FUSED_ACTIVATIONS = ("none", "relu", "squared_relu")
#: valid ``compact_grid`` modes: v3 ragged work queue / v2 / v1
COMPACT_GRID_MODES = ("ragged", "v2", "v1")
CompactGrid = Literal["ragged", "v2", "v1"]

_I32 = torch.int32


def _check_compact_grid(value) -> CompactGrid:
    """Normalize a grid-mode value to its canonical literal, rejecting
    anything unrecognized (legacy ``True``/``False`` mean v2/v1)."""
    if isinstance(value, str) and value in COMPACT_GRID_MODES:
        return value
    if value is True:
        return "v2"
    if value is False:
        return "v1"
    raise ValueError(
        f"compact_grid={value!r} not one of {COMPACT_GRID_MODES} "
        '("ragged" = v3 work queue, "v2"/True = max(nnz) grid, '
        '"v1"/False = full gated grid)'
    )


# ---------------------------------------------------------------------------
# planning metadata: on a CUDA tensor one launch of the planner kernel
# (csrc/block_mask.cu), on a CPU tensor the torch chains of .ref
# ---------------------------------------------------------------------------


def plan_blocks_csr(a: torch.Tensor, bm: int, bk: int):
    """The CSR plan ``(nnz [Mb], idx [Mb, Kb], row_starts [Mb+1], work_row,
    work_kblk [Mb*Kb])`` of ``a``'s effectual ``bm x bk`` blocks, int32."""
    block_mask.check_operand(a, bm, bk)
    if not block_mask.on_card(a):
        return ref.plan_blocks_csr_ref(a, bm, bk)
    return block_mask.launch_planner("values", a, a.shape[0] // bm, a.shape[1] // bk, bm=bm, bk=bk)


def plan_blocks(a: torch.Tensor, bm: int, bk: int):
    """Compacted effectual K-block lists of ``a``'s ``bm x bk`` blocks:
    ``(nnz [Mb], idx [Mb, Kb])`` int32."""
    return plan_blocks_csr(a, bm, bk)[:2]


def plan_workqueue(nnz: torch.Tensor, idx: torch.Tensor):
    """Flatten ``(nnz, idx)`` into the v3 CSR work queue ``(row_starts
    [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])`` with torch ops, on any
    device.  No plan the runtime builds needs it (each carries its queue
    from the planner); it serves plans handed in without one."""
    return ref.workqueue_ref(nnz, idx)


def plan_to_mask(nnz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The block-nonzero mask ``[Mb, Kb]`` (bool) a plan was compacted from."""
    return ref.plan_to_mask_ref(nnz, idx)


def plan_from_mask_csr(mask: torch.Tensor, *, coarsen: int = 1):
    """The CSR plan from an emitted ``[Mb, Nb]`` int8/bool mask, metadata
    only.  ``coarsen`` groups that many adjacent mask columns into one
    consumer K block (effectual iff any member is)."""
    mb, nb = mask.shape
    if nb % coarsen:
        raise ValueError(f"mask with {nb} columns cannot coarsen by {coarsen}")
    if not block_mask.on_card(mask):
        return ref.plan_from_mask_csr_ref(mask, coarsen=coarsen)
    return block_mask.launch_planner("emitted", mask, mb, nb // coarsen, bk=coarsen)


def plan_from_mask(mask: torch.Tensor, *, coarsen: int = 1):
    """:func:`plan_from_mask_csr`'s ``(nnz, idx)``."""
    return plan_from_mask_csr(mask, coarsen=coarsen)[:2]


def transpose_plan_csr(nnz: torch.Tensor, idx: torch.Tensor):
    """The CSR plan of ``a.T`` (blocks ``bk x bm``) from the plan of ``a``:
    the transposed block mask, compacted.  Metadata only, so the backward's
    weight-gradient product ``a.T @ g`` (paper Eq. 3) is planned without a
    second pass over ``a``."""
    if not block_mask.on_card(idx):
        return ref.transpose_plan_csr_ref(nnz, idx)
    mb, kb = idx.shape
    return block_mask.launch_planner("transpose", idx, kb, mb, fnnz=nnz)


def transpose_plan(nnz: torch.Tensor, idx: torch.Tensor):
    """:func:`transpose_plan_csr`'s ``(nnz, idx)``."""
    return transpose_plan_csr(nnz, idx)[:2]


def planned_grid_steps(nnz, kb: int, mb: int, nb: int, *, compact_grid="ragged") -> int:
    """Grid steps the planned kernel issues, the TPU kernel's "time": v1
    ``Mb * Nb * Kb``, v2 ``Mb * Nb * max(nnz, 1)``, ragged ``Nb *
    sum(max(nnz, 1))``.  A report helper: it reads ``nnz`` on the host (one
    copy); use ``SparsityPlan.grid_steps`` for a plan's cached count."""
    compact_grid = _check_compact_grid(compact_grid)
    # lint: allow-host-sync allow-np-on-device: a report helper, one copy of nnz
    nnz_h = np.asarray(torch.as_tensor(nnz).cpu())
    if compact_grid == "ragged":
        return nb * int(np.maximum(nnz_h, 1).sum())
    kdim = kb if compact_grid == "v1" else max(int(nnz_h.max(initial=0)), 1)
    return mb * nb * kdim


@functools.lru_cache(maxsize=256)
def dense_plan(mb: int, kb: int, device="cpu"):
    """The trivial all-effectual plan ``nnz = Kb``, ``idx = arange``, as
    int32 tensors on ``device``.  Memoized per ``(mb, kb, device)`` so a
    known-dense operand (the FFN gate's input) costs no host-to-device copy
    per call; the tensors are shared, so callers never edit them.  They are
    made outside inference mode whoever asks first: a serve call's plan is
    then saved for a later training step's backward."""
    dev = torch.device(device)
    with torch.inference_mode(False):
        nnz = torch.full((mb,), kb, dtype=_I32, device=dev)
        idx = torch.arange(kb, dtype=_I32, device=dev).expand(mb, kb).contiguous()
    return nnz, idx


@functools.lru_cache(maxsize=256)
def dense_plan_csr(mb: int, kb: int, device="cpu"):
    """:func:`dense_plan` plus its closed-form work queue (``row_starts =
    m * Kb``, every ``(m, k)`` pair in row-major order), memoized per
    ``(mb, kb, device)``, made outside inference mode as it is."""
    dev = torch.device(device)
    nnz, idx = dense_plan(mb, kb, dev)
    with torch.inference_mode(False):
        row_starts = torch.arange(mb + 1, dtype=_I32, device=dev) * kb
        work_row = torch.arange(mb, dtype=_I32, device=dev).repeat_interleave(kb)
        work_kblk = idx.reshape(-1).clone()
    return nnz, idx, row_starts, work_row, work_kblk


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: (operand dtype, output dtype) -> the kernel's ``out_type``: the operands'
#: type, bf16 from fp32 operands (the training backward's products), fp32
#: from bf16 operands (the K-sharded product's partials)
_OUT_TYPE = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 0,
             (torch.float32, torch.bfloat16): 1, (torch.bfloat16, torch.float32): 2}
_ACT_CODE = {"none": 0, "relu": 1, "squared_relu": 2}
# must match csrc/tensordash_spmm.cu
_THREADS, _WARPS = 256, 8
_SLICE_ROWS = 256  # the most rows a CTA's tile covers; taller block rows are cut into slices
_MAX_ROWS = 2048  # the largest bm the kernels take
_SMEM_MAX = 232448  # the 227 KB a block may use on Hopper
_MIN_STAGES, _MAX_STAGES = 3, 8
# the tile and split rule (tensordash_spmm.cu's note says why)
_TN_CAP = 128  # widest column tile
_KC = {2: 64, 4: 32}  # K elements per pipeline stage, by element size
_SMEM_BUDGET = 72 * 1024  # ring bytes per CTA: three CTAs share an SM
_CTAS_PER_SM = 3  # resident CTAs per SM the bf16 decode tile is built for (2 for the others)
_SM_SMEM = 233472  # shared memory of one SM (228 KB), 1 KB of it reserved per CTA
_PARTIAL_SHARE = 8  # split partials stay below 1/8 of the bytes a tile streams
_CTA_STEPS = 4  # a CTA's fixed cost in ring steps: filling the ring, the split-K epilogue


class Tile(NamedTuple):
    """One launch's CTA tile: ``rows x tn`` outputs (``tn`` divides ``bn``;
    ``rows`` is ``bm``, or for ``bm`` past 256 its largest divisor up to 256,
    and ``slices = bm / rows`` CTAs cover a block row) on 8 warps, the wide
    side on the MMA's rows (``swap``: the output's
    columns, so the CTA computes ``C^T`` tiles), ``wp x wq`` warps of
    ``mt`` m16 by ``nt`` n8 MMA tiles each, a ring of ``stages`` K chunks of
    ``kc`` elements, ``smem`` bytes of dynamic shared memory."""

    rows: int
    slices: int
    tn: int
    kc: int
    stages: int
    swap: bool
    wp: int
    wq: int
    mt: int
    nt: int
    smem: int

    @property
    def extents(self) -> tuple[int, int]:
        """Padded MMA row and column extents of the tile."""
        return self.wp * 16 * self.mt, self.wq * 8 * self.nt


def _divisor_at_most(dim: int, cap: int) -> int:
    b = max(1, min(cap, dim))
    while dim % b:
        b -= 1
    return b


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


#: the warp tiles the kernel is built for, smallest first: ``(mt, nt)`` m16
#: by n8 MMA tiles a warp (the decode tile, 16 x 32, 32 x 32)
_WARP_TILES = ((1, 1), (1, 4), (2, 4))


def _warp_grid(ep: int, eq: int):
    """``(wp, wq, mt, nt)``: the smallest warp tile and a power-of-two grid
    of at most 8 warps covering ``ep`` MMA rows and ``eq`` columns, or
    ``None``."""
    for mt, nt in _WARP_TILES:
        for wq in (1, 2, 4, 8):
            wp = _pow2_at_least(-(-ep // (16 * mt)))
            if wq * 8 * nt >= eq and wp * wq <= _WARPS:
                return wp, wq, mt, nt
    return None


def _stage_bytes(p_pad: int, q_pad: int, kc: int, esz: int) -> int:
    """Shared-memory bytes of one ring stage (both operand tiles, either
    orientation, rows padded by 16 bytes, each tile 128-byte aligned)."""
    v = 16 // esz
    tile = lambda x: (x * kc + v * max(x, kc)) * esz
    return sum(-(-tile(x) // 128) * 128 for x in (p_pad, q_pad))


@functools.lru_cache(maxsize=1024)
def kernel_tile(bm: int, bk: int, bn: int, esz: int = 2) -> Tile:
    """The CUDA kernel's tile for a ``(bm, bk, bn)`` launch of ``esz``-byte
    elements: ``rows``, the largest divisor of ``bm`` up to 256 (so the
    kernel needs no bound for a short slice); the widest column tile ``tn <= 128``
    dividing ``bn`` whose ``rows x tn`` tile 8 warps cover with one of the
    kernel's warp tiles, the wide side on the MMA rows; K chunks of 64
    (bf16) or 32 (fp32) elements; as many ring stages (3 to 8) as fit
    72 KB."""
    if bm > _MAX_ROWS:
        raise ValueError(f"bm={bm} exceeds the CUDA kernel's {_MAX_ROWS} rows")
    rows = _divisor_at_most(bm, _SLICE_ROWS)
    slices = bm // rows
    tn = _divisor_at_most(bn, _TN_CAP)
    while True:
        for swap in (tn > rows, tn <= rows):
            grid = _warp_grid(*((tn, rows) if swap else (rows, tn)))
            if grid is not None:
                break
        if grid is not None:
            break
        tn = _divisor_at_most(bn, tn - 1)
    wp, wq, mt, nt = grid
    p_pad, q_pad = wp * 16 * mt, wq * 8 * nt
    kc = min(_KC[esz], max(16, _pow2_at_least(bk)))
    while kc > 16 and _MIN_STAGES * _stage_bytes(p_pad, q_pad, kc, esz) > _SMEM_MAX:
        kc //= 2
    stage = _stage_bytes(p_pad, q_pad, kc, esz)
    stages = max(_MIN_STAGES, min(_MAX_STAGES, _SMEM_BUDGET // stage))
    if stages * stage > _SMEM_MAX:
        raise ValueError(f"block geometry bm={bm} bn={bn} does not fit shared memory")
    return Tile(rows, slices, tn, kc, stages, swap, wp, wq, mt, nt, stages * stage)


@functools.lru_cache(maxsize=1024)
def kernel_splits(tiles: int, kb: int, sms: int, cap: int | None = None,
                  resident: int | None = None, chunks: int = 1) -> int:
    """How many contiguous shares ``S`` each block row's effectual list is
    cut into, from the shapes alone: the ``S`` (at most ``Kb``, the longest
    a row's list can be, known without reading ``nnz`` on the host, and at
    most ``cap``) whose CTAs take the fewest waves of ``resident`` per SM
    times ring steps per CTA (``chunks`` K chunks a block, plus a CTA's
    fixed cost), the smallest on ties; then the fewest shares of that
    length, so no share of a dense row is empty."""
    slots = (resident or _CTAS_PER_SM) * sms
    cost = lambda s: -(-tiles * s // slots) * (-(-kb // s) * chunks + _CTA_STEPS)
    s = min(range(1, max(1, min(kb, cap or kb)) + 1), key=lambda s: (cost(s), s))
    return -(-kb // -(-kb // s))


def resident_ctas(tile: Tile, esz: int) -> int:
    """CTAs of this tile an SM holds at once: the kernel's launch bounds
    guarantee 3 for the bf16 decode warp tile (1 x 1) and 2 for the others
    by registers; the ring's shared memory may allow fewer."""
    regs = _CTAS_PER_SM if (tile.mt, tile.nt) == (1, 1) and esz == 2 else 2
    return max(1, min(regs, _SM_SMEM // (tile.smem + 1024)))


def _split_cap(k: int, tile: Tile, esz: int) -> int:
    """The most splits whose fp32 partials (one per split, in fragment
    order) stay below 1/8 of the operand bytes a tile streams."""
    ep, eq = (tile.tn, tile.rows) if tile.swap else (tile.rows, tile.tn)
    partial = tile.mt * tile.nt * _THREADS * 16
    return max(1, k * (ep + eq) * esz // (_PARTIAL_SHARE * partial))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_splits(m: int, k: int, n: int, bm: int, bk: int, bn: int, device,
                  dtype=torch.bfloat16) -> int:
    """The split count ``S`` a launch of ``[m, k] @ [k, n]`` at ``(bm, bk,
    bn)`` in ``dtype`` uses on ``device``'s card (the same for every grid
    family; a function of the shapes only)."""
    esz = torch.empty((), dtype=dtype).element_size()
    tile = kernel_tile(bm, bk, bn, esz)
    tiles = (n // tile.tn) * tile.slices * (m // bm)
    index = torch.device(device).index
    sms = _sm_count(torch.cuda.current_device() if index is None else index)
    return kernel_splits(tiles, k // bk, sms, _split_cap(k, tile, esz), resident_ctas(tile, esz),
                         -(-bk // tile.kc))


def _vec_ok(t: torch.Tensor, lead_stride: int, *extents: int) -> int:
    """1 when 16-byte loads along ``t``'s unit-stride dimension stay aligned:
    the base pointer, the other stride and every tile extent along it are
    multiples of 16 bytes' worth of elements."""
    v = 16 // t.element_size()
    return int(t.data_ptr() % 16 == 0 and lead_stride % v == 0 and all(x % v == 0 for x in extents))


def _meta(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=device).contiguous()


def check_launch(m: int, bm: int, bk: int, bn: int) -> None:
    """Raise ``ValueError`` for a geometry the CUDA kernels cannot take:
    more than 65535 block rows (the grid's y extent), or ``bm`` past
    ``_MAX_ROWS`` (2048; :func:`kernel_tile` cuts a block row past 256 rows
    into equal slices, one CTA each)."""
    if m // bm > 65535:
        raise ValueError(f"{m // bm} block rows exceed the CUDA grid's y extent")
    kernel_tile(bm, bk, bn)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


#: kernel launches since the last :func:`reset_launch_counts`, per wrapper
#: and grid family ("tensordash_matmul_planned" is the ragged family)
_LAUNCHES: dict[str, int] = {}
_COUNTERS = tuple(f"{w}{'' if g == 'ragged' else f'[{g}]'}"
                  for w in ("tensordash_matmul_planned", "tensordash_matmul_fused")
                  for g in COMPACT_GRID_MODES)
#: per device and stream: the kernels' arrival counters, all zero between
#: launches (each launch's last CTAs reset the ones they used); launches on
#: one stream run one after another, so they never share a counter at once
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}


#: inside :func:`holding`: what the launches there read from outside a
#: CUDA graph's memory pool; ``None`` outside
_HELD: list | None = None


@contextlib.contextmanager
def holding():
    """Collect, until the block ends, what the products and launches made in
    it read through raw pointers from memory that a cache owns: the plans
    handed to a backend (the plan cache's, the dense-plan memo's) and the
    counter workspaces.  A CUDA graph captured in the block replays those
    pointers, so its owner keeps the list as long as it keeps the graph: a
    cache that evicts one of them then cannot free it under the graph."""
    global _HELD
    prev, _HELD = _HELD, []
    try:
        yield _HELD
    finally:
        _HELD = prev


def hold(*objs) -> None:
    """Add ``objs`` to the innermost :func:`holding` block's list (outside
    one: nothing)."""
    if _HELD is not None:
        _HELD.extend(objs)


def _launched(wrapper: str, grid: str) -> None:
    _LAUNCHES[wrapper if grid == "ragged" else f"{wrapper}[{grid}]"] += 1


def _arrivals(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """The counter workspace of ``device``'s ``stream`` (a raw
    ``cudaStream_t``), at least ``count`` int32 (zeroed once, when it is first
    made or outgrown, on that stream)."""
    key = (device.index, stream)
    ws = _ARRIVALS.get(key)
    if ws is None or ws.numel() < count:
        ws = torch.zeros(max(count, 1 << 16), dtype=_I32, device=device)
        _ARRIVALS[key] = ws
    hold(ws)
    return ws


def _launch(wrapper, nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue, *,
            bias=None, residual=None, activation="none", split_shape=None):
    """Validate and run one CUDA launch of ``wrapper`` (``"planned"`` or
    ``"fused"``); returns ``(out, mask)`` (``mask`` None when planned).
    ``split_shape`` ``(m, k, n)``, or ``(m, k, n, bm, bk, bn)``: cut K into
    the shares a launch of that shape (at those blocks; default this
    launch's) would (see :func:`tensordash_matmul_planned`)."""
    from repro_torch.kernels import _build

    m, k, n = ref._check_blocks(a, b, bm, bk, bn)
    check_launch(m, bm, bk, bn)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, bias, residual)):
        # the output is filled through a raw pointer and has no grad_fn
        raise RuntimeError(
            f"tensordash_matmul_{wrapper}: an operand requires grad; differentiate through "
            "repro_torch.runtime.autodiff (Runtime.matmul / matmul_fused), or call under torch.no_grad()")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"CUDA kernel takes float32 or bfloat16 operands of one dtype, got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if (a.dtype, out_dtype) not in _OUT_TYPE:
        raise TypeError(f"CUDA kernel writes {a.dtype} operands as {a.dtype} (float32 also as bfloat16, "
                        f"bfloat16 also as float32), not as {out_dtype}")
    dev = a.device
    args = _build.SpmmArgs(kdim=0, M=m, K=k, N=n, bm=bm, bk=bk, bn=bn,
                           activation=_ACT_CODE[activation], out_type=_OUT_TYPE[a.dtype, out_dtype])
    keep = []  # the tensors behind the pointers, held until the launch is queued
    if grid == "ragged":
        if workqueue is None:
            workqueue = plan_workqueue(_meta(nnz, dev), _meta(idx, dev))
        row_starts, _, work_kblk = (_meta(t, dev) for t in workqueue)
        args.row_starts, args.work_kblk = row_starts.data_ptr(), work_kblk.data_ptr()
        keep += [row_starts, work_kblk]
    else:
        idx_t = _meta(idx, dev)
        if tuple(idx_t.shape) != (m // bm, k // bk):
            raise ValueError(f"idx {tuple(idx_t.shape)} is not the plan of [{m}, {k}] at ({bm}, {bk})")
        args.idx, args.kdim = idx_t.data_ptr(), k // bk if grid == "v1" else 0
        keep.append(idx_t)
    nnz_t = _meta(nnz, dev)
    args.nnz = nnz_t.data_ptr()
    tile = kernel_tile(bm, bk, bn, a.element_size())
    tiles = (n // tile.tn) * tile.slices * (m // bm)
    whole = tuple(split_shape or (m, k, n))
    splits = launch_splits(*whole[:3], *(whole[3:] or (bm, bk, bn)), dev, a.dtype)
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    args.a, args.sam, args.sak = a.data_ptr(), sam, sak
    args.b, args.sbk, args.sbn = b.data_ptr(), sbk, sbn
    # each operand is staged K-contiguous when its K stride is 1, else along
    # its own dimension; 16-byte copies where that dimension is aligned
    args.a_kmaj = int(sak == 1 or sam != 1)
    args.a_vec = (_vec_ok(a, sam, bk) if sak == 1 else _vec_ok(a, sak, bm, tile.rows) if sam == 1 else 0)
    args.b_kmaj = int(sbk == 1 or sbn != 1)
    args.b_vec = (_vec_ok(b, sbn, bk) if sbk == 1 else _vec_ok(b, sbk, tile.tn) if sbn == 1 else 0)
    args.rows, args.TN, args.KC, args.S, args.stages = tile.rows, tile.tn, tile.kc, splits, tile.stages
    args.swap, args.wp, args.wq, args.mt, args.nt = int(tile.swap), tile.wp, tile.wq, tile.mt, tile.nt
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    args.out = out.data_ptr()
    mask = None
    if wrapper == "fused":
        if bias is not None:
            if bias.shape != (n,):
                raise ValueError(f"bias {tuple(bias.shape)} != ({n},)")
            bias = bias.to(device=dev, dtype=torch.float32).contiguous()
            args.bias = bias.data_ptr()
            keep.append(bias)
        if residual is not None:
            if residual.shape != (m, n) or residual.dtype != a.dtype or residual.device != dev:
                raise ValueError(f"residual must be [{m}, {n}] {a.dtype} on {dev}")
            residual = residual.contiguous()
            args.residual = residual.data_ptr()
            keep.append(residual)
        mask = torch.empty((m // bm, n // bn), dtype=torch.int8, device=dev)  # every byte written
        args.mask = mask.data_ptr()
    stream = torch.cuda.current_stream(dev)
    args.counters = _arrivals(dev, stream.cuda_stream, tiles + (m // bm) * (n // bn)).data_ptr()
    if splits > 1:
        partial = torch.empty(tiles * splits * tile.mt * tile.nt * _THREADS * 4,
                              dtype=torch.float32, device=dev)
        args.partial = partial.data_ptr()
        keep.append(partial)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.td_spmm(_DTYPE_CODE[a.dtype], int(wrapper == "fused"), int(grid != "ragged"),
                         ctypes.byref(args), stream.cuda_stream)
    _raise_on(rc, f"tensordash_matmul_{wrapper}")
    _launched(f"tensordash_matmul_{wrapper}", grid)
    return out, mask


def tensordash_matmul_planned(nnz, idx, a: torch.Tensor, b: torch.Tensor, *,
                              bm: int = 128, bk: int = 512, bn: int = 128,
                              out_dtype=None, compact_grid="ragged", workqueue=None, split_shape=None):
    """Block-sparse ``a @ b`` given a precomputed block plan.  ``a`` and ``b``
    may be strided views (the side-B LM head passes ``lm_head.T``); the
    output is contiguous, in ``out_dtype``: the operands' dtype, bfloat16
    for float32 operands (the training backward's products, one rounding
    of the fp32 accumulator in the same launch) or float32 for bfloat16
    operands (the K-sharded product's partials: the accumulator itself).  ``workqueue``
    optionally supplies the plan's ``(row_starts, work_row, work_kblk)``
    (ragged only; v1/v2 read ``idx``).  The output has no ``grad_fn``: on
    the card an operand that requires grad raises while grad mode is on
    (:mod:`repro_torch.runtime.autodiff` differentiates it).

    ``split_shape`` ``(m, k, n)`` names the whole product this launch is a
    row or column shard of: the kernel then cuts each row's K list into the
    shares that product's launch would (the split count follows from the
    shapes and the blocks: this launch's, or the whole launch's ``(bm, bk,
    bn)`` appended to the shape), and sums them in the same order, so the
    shard's output equals those rows or columns of the whole product bit
    for bit (:mod:`repro_torch.parallel.spmm`).  The CPU path has no split."""
    grid = _check_compact_grid(compact_grid)
    if a.device.type == "cpu":  # every family runs the same schedule
        return ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _launch("planned", nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue,
                   split_shape=split_shape)[0]


def tensordash_matmul_fused(nnz, idx, a: torch.Tensor, b: torch.Tensor,
                            bias: torch.Tensor | None = None,
                            residual: torch.Tensor | None = None, *,
                            activation: str = "none", bm: int = 128, bk: int = 512,
                            bn: int = 128, out_dtype=None, compact_grid="ragged",
                            workqueue=None, split_shape=None):
    """Planned ``act(a @ b + bias) + residual`` with the epilogue applied to
    the fp32 accumulator, plus the emitted output mask.  Returns ``(out
    [M, N], mask int8 [M/bm, N/bn])``."""
    if activation not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {FUSED_ACTIVATIONS}")
    grid = _check_compact_grid(compact_grid)
    if a.device.type == "cpu":
        return ref.tensordash_matmul_fused_ref(
            nnz, idx, a, b, bias, residual, bm=bm, bk=bk, bn=bn,
            activation=activation, out_dtype=out_dtype,
        )
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _launch("fused", nnz, idx, a, b, bm, bk, bn, out_dtype, grid, workqueue,
                   bias=bias, residual=residual, activation=activation, split_shape=split_shape)


def tensordash_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 512,
                      bn: int = 128, out_dtype=None, compact_grid="ragged"):
    """Dynamic block-sparse ``a @ b``: plan at run time (one planner launch
    in ``values`` mode on the card), then execute over that plan's work
    queue."""
    nnz, idx, row_starts, work_row, work_kblk = plan_blocks_csr(a, bm, bk)
    return tensordash_matmul_planned(
        nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype, compact_grid=compact_grid,
        workqueue=(row_starts, work_row, work_kblk),
    )


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`: per
    wrapper and grid family (the ragged family under the bare wrapper
    name, v2/v1 as ``"<wrapper>[v2]"``) and per planner mode
    (``"block_zero_mask"``, ``"planner[values]"``, ``"planner[emitted]"``,
    ``"planner[transpose]"``)."""
    return {**{c: _LAUNCHES[c] for c in _COUNTERS}, **block_mask.LAUNCHES}


def reset_launch_counts() -> None:
    _LAUNCHES.update(dict.fromkeys(_COUNTERS, 0))
    block_mask.LAUNCHES.update(dict.fromkeys(block_mask.LAUNCHES, 0))


reset_launch_counts()
