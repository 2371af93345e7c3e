"""Distributed sparse execution: per-shard ragged work queues on
``torch.distributed`` (port of ``repro/parallel/spmm.py``).

The planned SpMM walks a CSR work queue of ``sum(max(nnz, 1))`` items, so
its time tracks effectual work.  This module lifts that onto a mesh: a plan
is split along M (row-parallel over the policy's data axes), N
(column-parallel over the model axis) or K (the contraction, over the model
axis), and every rank builds its work queue from its own shard, so each
rank's grid is ``O(sum(nnz_shard))`` and the load follows local effectual
work, not the global ``max(nnz)``.

Each executor is two halves:

* a **local step**, :func:`local_step` (``(shard, n_shards, request) ->
  this shard's output``): the shard's slice of the operands and its work
  queue (:func:`local_request`), then the backend's ``execute_planned`` or
  ``execute_fused``: the CUDA kernel on the card, the plain executor on the
  CPU.  It needs no process group, so one card can run every rank's step in
  turn;
* a thin **collective**: M all-gathers the row blocks and undoes the
  balanced deal, N all-gathers the column blocks (both through
  :func:`assemble`, which also puts together pieces gathered by hand), and
  K sums the fp32 partials with an ``all_reduce`` and casts them back.

Per axis:

* ``"M"``: ``a``'s block rows are dealt serpentine by descending work
  (:func:`repro_torch.runtime.plan.balanced_row_order`), ``b`` is
  replicated.  Every contraction is complete on its rank: bit-identical to
  one device.
* ``"N"``: ``b``'s columns are split and the schedule is replicated:
  bit-identical.

  On the card an M or N shard's launch carries the whole product's shape
  (``KernelRequest.split_shape``), so the kernel cuts each row's K list
  into the shares the whole launch would and sums them in the same order:
  a smaller launch would otherwise pick more split-K shares and round
  differently.
* ``"K"``: each rank replans its K-block slice from the expanded block mask
  (metadata only) and writes fp32 partials whatever the operands' dtype;
  the reassociated sum is allclose, not bitwise, and a fused epilogue
  cannot distribute over it, so fused K-sharding is refused.

Differentiation: :class:`ShardedVJP` is the single-device rule of
:mod:`repro_torch.runtime.autodiff` with every product sharded: ``da = g @
b.T`` over the cotangent's rows (M), ``db = a.T @ g`` over its columns (N),
both device-local, so both gradients are bit-identical to one device.

Everything degrades as in the JAX package: no mesh, a mesh without the
axis, a blocked shape that does not divide the shard count, or an injected
shard failure run the unsharded executor; :func:`shard_count` says how
many shards a request runs on.  Every rank of the group must take the same
branch (the same fault plan, the same shapes), as every rank of one SPMD
program does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels.tensordash_spmm import (
    _check_compact_grid,
    hold,
    plan_from_mask_csr,
    plan_to_mask,
    plan_workqueue,
)
from repro_torch.parallel.sharding import ShardingPolicy
from repro_torch.runtime.autodiff import (
    FusedVJP,
    PlannedVJP,
    fused_planned_matmul,
    planned_matmul,
    planned_matmul_grads,
)
from repro_torch.runtime.backends import KernelRequest, get_backend, needs_grad
from repro_torch.runtime.plan import SparsityPlan, balanced_row_order, capturing
from repro_torch.runtime.runtime import resolve

__all__ = [
    "ShardedVJP",
    "ShardedFusedVJP",
    "shard_count",
    "shard_order",
    "local_request",
    "local_step",
    "assemble",
    "sharded_execute_planned",
    "sharded_execute_fused",
    "sharded_matmul",
    "sharded_matmul_fused",
    "sharded_matmul_grads",
]


def _take_block_rows(x, order, bm: int):
    """``x``'s block rows (rows ``[i*bm, (i+1)*bm)`` move as one) in
    ``order``: pure data movement, so execution on it stays bitwise."""
    blocks = x.reshape(x.shape[0] // bm, bm, *x.shape[1:])
    return blocks.index_select(0, order.to(x.device, torch.long)).reshape(-1, *x.shape[1:])


def _plan_block_mask(nnz, idx):
    """The bool ``[Rb, Kb]`` block mask of compacted ``(nnz, idx)``."""
    return plan_to_mask(torch.as_tensor(nnz), torch.as_tensor(idx))


def _divides(req: KernelRequest, axis: str, n_shards: int) -> bool:
    """Whether the sharded dim splits evenly into ``n_shards`` whole blocks."""
    if axis == "M":
        return (req.a.shape[0] // req.bm) % n_shards == 0
    if axis == "N":
        return (req.b.shape[1] // req.bn) % n_shards == 0
    return (req.a.shape[1] // req.bk) % n_shards == 0


def shard_order(req: KernelRequest, n_shards: int, balance: bool = True):
    """The M axis's block-row deal (shard-major, on ``req.nnz``'s device):
    serpentine by work when ``balance``, else contiguous."""
    nnz = torch.as_tensor(req.nnz)
    if balance:
        return balanced_row_order(nnz, n_shards)
    return torch.arange(nnz.shape[0], dtype=torch.int32, device=nnz.device)


def local_request(req: KernelRequest, axis: str, shard: int, n_shards: int, *,
                  order=None) -> KernelRequest:
    """Shard ``shard``'s request: its slice of the operands and its own work
    queue.  M takes the block rows ``order`` deals it (:func:`shard_order`),
    N its output columns (the global queue serves every shard), both with
    the whole product's ``split_shape``; K its K-block slice, replanned from
    the block mask, with fp32 output."""
    ragged = req.compact_grid == "ragged"
    whole = req.split_shape or (req.a.shape[0], req.a.shape[1], req.b.shape[1])
    if axis == "M":
        rows = req.a.shape[0] // req.bm // n_shards
        mine = order[shard * rows:(shard + 1) * rows]
        nnz = torch.as_tensor(req.nnz)[mine.long()]
        idx = torch.as_tensor(req.idx)[mine.long()]
        residual = req.residual
        if residual is not None:
            residual = _take_block_rows(residual, mine, req.bm)
        return dataclasses.replace(
            req, nnz=nnz, idx=idx, a=_take_block_rows(req.a, mine, req.bm), residual=residual,
            workqueue=plan_workqueue(nnz, idx) if ragged else None, split_shape=whole,
        )
    if axis == "N":
        cols = req.b.shape[1] // n_shards
        sl = slice(shard * cols, (shard + 1) * cols)
        wq = req.workqueue
        if ragged and wq is None:
            wq = plan_workqueue(torch.as_tensor(req.nnz), torch.as_tensor(req.idx))
        return dataclasses.replace(
            req, b=req.b[:, sl],
            bias=req.bias[sl] if req.bias is not None else None,
            residual=req.residual[:, sl] if req.residual is not None else None,
            workqueue=wq if ragged else None, split_shape=whole,
        )
    if axis != "K":
        raise ValueError(f"shard axis {axis!r} not in ('M', 'N', 'K')")
    kb = req.a.shape[1] // req.bk
    kbl, kl = kb // n_shards, req.a.shape[1] // n_shards
    mask = _plan_block_mask(req.nnz, req.idx)[:, shard * kbl:(shard + 1) * kbl].contiguous()
    nnz, idx, rs, wr, wk = plan_from_mask_csr(mask)
    return dataclasses.replace(
        req, nnz=nnz, idx=idx, a=req.a[:, shard * kl:(shard + 1) * kl],
        b=req.b[shard * kl:(shard + 1) * kl], out_dtype=torch.float32,
        workqueue=(rs, wr, wk) if ragged else None, split_shape=None,
    )


def local_step(backend: str, req: KernelRequest, axis: str, shard: int, n_shards: int, *,
               balance: bool = True, fused: bool = False):
    """Shard ``shard``'s output of the sharded product: what rank ``shard``
    of the group computes before the collective (M: its dealt block rows; N:
    its output columns; K: its fp32 partial).  Needs no process group."""
    order = shard_order(req, n_shards, balance) if axis == "M" else None
    req_l = local_request(req, axis, shard, n_shards, order=order)
    be = get_backend(backend)
    return be.execute_fused(req_l) if fused else be.execute_planned(req_l)


def assemble(axis: str, pieces: list, req: KernelRequest, *, order=None, fused: bool = False):
    """The global output from every shard's local output, in shard order,
    as the collective puts it together: M concatenates row blocks and undoes
    the deal ``order``, N concatenates column blocks, K sums the fp32
    partials in shard order and casts them to the output dtype.  Fused
    pieces are ``(out, mask)`` pairs."""
    if axis == "K":
        total = pieces[0].float()
        for p in pieces[1:]:
            total = total + p
        return total.to(req.out_dtype or req.a.dtype)
    dim = 0 if axis == "M" else 1
    outs = [p[0] for p in pieces] if fused else pieces
    out = torch.cat(outs, dim)
    mask = torch.cat([p[1] for p in pieces], dim) if fused else None
    if axis == "M" and order is not None:
        inv = torch.argsort(order.long())  # argsort of a permutation is its inverse
        out = _take_block_rows(out, inv, req.bm)
        if fused:
            mask = mask.index_select(0, inv.to(mask.device))
    return (out, mask) if fused else out


def _gathered(x, group) -> list:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _collect(axis: str, local, req: KernelRequest, group, order, fused: bool):
    """The collective half: this rank's local output -> the global output."""
    if axis == "K":
        dist.all_reduce(local, group=group)  # fp32 partials
        return local.to(req.out_dtype or req.a.dtype)
    if fused:
        pieces = list(zip(_gathered(local[0], group), _gathered(local[1], group)))
    else:
        pieces = _gathered(local, group)
    return assemble(axis, pieces, req, order=order, fused=fused)


def _injected_shard_fault(site: str) -> bool:
    """Consult the ambient :class:`repro_torch.resilience.faults.FaultPlan`:
    ``shard_stall`` sleeps host-side at dispatch (a slow shard, caught by
    the callers' deadlines); ``shard_fail`` returns True, which the
    executors contain by running unsharded, with a warning and a
    ``ResilienceLog`` event."""
    from repro_torch.resilience import faults as _faults  # local: keep import light

    fp = _faults.active()
    if fp is None:
        return False
    t = fp.tick(site)
    _faults.stall(fp, "shard_stall", t)
    if fp.fires("shard_fail", t):
        import warnings

        from repro_torch.resilience.log import record as _record

        warnings.warn(f"shard failure at {site} (injected): degrading to unsharded execution",
                      RuntimeWarning, stacklevel=3)
        _record("shard", site, "fallback-unsharded", tick=t)
        return True
    return False


def shard_count(req: KernelRequest, policy: ShardingPolicy, axis: str = "M") -> int:
    """How many shards ``req`` runs on under ``policy``: the axis's shard
    count, or 1 where the executors fall back (no mesh or axis, or a blocked
    dim that does not divide)."""
    _, n_shards, _ = policy.spmm_axes(axis)
    return n_shards if n_shards > 1 and _divides(req, axis, n_shards) else 1


def _sharded(backend: str, req: KernelRequest, policy: ShardingPolicy, axis: str,
             balance: bool, fused: bool):
    be = get_backend(backend)
    run_whole = be.execute_fused if fused else be.execute_planned
    n_shards = shard_count(req, policy, axis)
    if n_shards == 1 or _injected_shard_fault(f"parallel.execute_{'fused' if fused else 'planned'}"):
        return run_whole(req)
    _, _, group = policy.spmm_axes(axis)
    shard = dist.get_rank(group)
    order = shard_order(req, n_shards, balance) if axis == "M" else None
    req_l = local_request(req, axis, shard, n_shards, order=order)
    local = be.execute_fused(req_l) if fused else be.execute_planned(req_l)
    return _collect(axis, local, req, group, order, fused)


def sharded_execute_planned(backend: str, req: KernelRequest, policy: ShardingPolicy, *,
                            axis: str = "M", balance: bool = True):
    """Planned ``a @ b`` distributed per ``policy``: the global operands in
    (every rank holds them), the global output out, on every rank."""
    return _sharded(backend, req, policy, axis, balance, fused=False)


def sharded_execute_fused(backend: str, req: KernelRequest, policy: ShardingPolicy, *,
                          axis: str = "M", balance: bool = True):
    """Fused ``act(a @ b + bias) + residual`` distributed per ``policy``;
    ``(out, mask)`` in the global layout.  ``"K"`` is refused: the
    nonlinear epilogue cannot distribute over the sum of partials."""
    if axis == "K":
        raise NotImplementedError(
            "fused K-sharded execution is unsupported: the epilogue (bias/activation) must run "
            "after the psum; shard M or N, or apply the epilogue outside the kernel")
    return _sharded(backend, req, policy, axis, balance, fused=True)


# ---------------------------------------------------------------------------
# differentiation: the sharded twins of runtime/autodiff's rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedVJP(PlannedVJP):
    """:class:`~repro_torch.runtime.autodiff.PlannedVJP` whose every product
    runs on per-shard queues: the forward on :attr:`axis`, the backward's
    ``da`` M-sharded over the cotangent's rows and ``db`` N-sharded over
    its columns (the axes ``autodiff`` names for them).  Both stay
    rank-local, so both gradients are bit-identical to one device."""

    policy: ShardingPolicy = ShardingPolicy()
    axis: str = "M"
    balance: bool = True

    def _execute(self, nnz, idx, a, b, *, bm, bk, bn, out_dtype, workqueue=None, compact_grid=None,
                 axis=None):
        req = KernelRequest(
            nnz=nnz, idx=idx, a=a, b=b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype,
            compact_grid=self.compact_grid if compact_grid is None else compact_grid,
            workqueue=workqueue,
        )
        return sharded_execute_planned(self.backend, req, self.policy, axis=axis or self.axis,
                                       balance=self.balance)


@dataclasses.dataclass(frozen=True)
class ShardedFusedVJP(ShardedVJP, FusedVJP):
    """Sharded twin of :class:`~repro_torch.runtime.autodiff.FusedVJP`: the
    fused epilogue's rule (the emitted-mask cotangent plan included) with
    every product sharded."""

    def _execute_fused(self, req):
        return sharded_execute_fused(self.backend, req, self.policy, axis=self.axis, balance=self.balance)


#: both training cotangents ``(da, db)``: under a :class:`ShardedVJP` context
#: the single-device rule runs each product on per-shard queues
sharded_matmul_grads = planned_matmul_grads


def _validate_launch(plan: SparsityPlan, validate: str | None) -> None:
    """Gated static verification of a plan at the distributed launch
    boundary (``Runtime(validate=...)``, the ambient runtime's when not
    passed); skipped while a CUDA graph is captured."""
    if validate is None:
        validate = resolve().validate
    if validate != "off" and not capturing():
        from repro_torch.analysis.plan_check import check_plan  # local: keep import light

        check_plan(plan, level=validate)


def sharded_matmul(plan: SparsityPlan, a, b, *, bn: int, backend: str, policy: ShardingPolicy,
                   axis: str = "M", balance: bool = True, out_dtype=None, plan_cache=None,
                   plan_key=None, compact_grid="ragged", validate: str | None = None, db=None):
    """Sharded planned ``a @ b`` with the distributed sparsity-aware
    backward: the sharded twin of ``KernelBackend.matmul_planned`` (one
    executor call when autograd needs no gradient).  ``validate`` (default:
    the ambient runtime's level) verifies the plan first."""
    _validate_launch(plan, validate)
    compact_grid = _check_compact_grid(compact_grid)
    hold(plan)
    wq = plan.workqueue() if compact_grid == "ragged" else None
    if not needs_grad(a, b):
        req = KernelRequest(nnz=plan.nnz, idx=plan.idx, a=a, b=b, bm=plan.bm, bk=plan.bk, bn=bn,
                            out_dtype=out_dtype, compact_grid=compact_grid, workqueue=wq)
        return sharded_execute_planned(backend, req, policy, axis=axis, balance=balance)
    ctx = ShardedVJP(backend=backend, bm=plan.bm, bk=plan.bk, bn=bn, out_dtype=out_dtype,
                     cache=plan_cache, key=plan_key, compact_grid=compact_grid, db=db,
                     policy=policy, axis=axis, balance=balance)
    return planned_matmul(ctx, plan.nnz, plan.idx, a, b, wq)


def sharded_matmul_fused(plan: SparsityPlan, a, b, *, bias=None, residual=None,
                         activation: str = "none", bn: int, backend: str, policy: ShardingPolicy,
                         axis: str = "M", balance: bool = True, out_dtype=None, plan_cache=None,
                         plan_key=None, compact_grid="ragged", validate: str | None = None, db=None):
    """Sharded fused matmul with the distributed backward, the sharded twin
    of ``KernelBackend.matmul_fused``; returns ``(out, mask)``.  ``validate``
    as in :func:`sharded_matmul`."""
    _validate_launch(plan, validate)
    compact_grid = _check_compact_grid(compact_grid)
    hold(plan)
    wq = plan.workqueue() if compact_grid == "ragged" else None
    if not needs_grad(a, b, bias, residual):
        req = KernelRequest(nnz=plan.nnz, idx=plan.idx, a=a, b=b, bias=bias, residual=residual,
                            activation=activation, bm=plan.bm, bk=plan.bk, bn=bn,
                            out_dtype=out_dtype, compact_grid=compact_grid, workqueue=wq)
        return sharded_execute_fused(backend, req, policy, axis=axis, balance=balance)
    ctx = ShardedFusedVJP(backend=backend, bm=plan.bm, bk=plan.bk, bn=bn, out_dtype=out_dtype,
                          cache=plan_cache, key=plan_key, activation=activation,
                          compact_grid=compact_grid, db=db, policy=policy, axis=axis, balance=balance)
    return fused_planned_matmul(ctx, plan.nnz, plan.idx, a, b, bias, residual, wq)
