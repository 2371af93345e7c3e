"""Sparsity-aware differentiation of the planned matmul (port of
``repro/runtime/autodiff.py``).

TensorDash's training claim rests on exploiting sparsity in all three
per-layer products (paper Eq. 1-3):

* ``FWD`` (A*W)         — the planned forward ``out = a @ b``;
* ``BWD_INPUT`` (W*G)   — ``da = g @ b.T``, sparse stream = the output
  gradient ``g``, planned by value or, behind a ReLU-family fused epilogue,
  from the mask the forward kernel emitted;
* ``BWD_WEIGHT`` (A*G)  — ``db = a.T @ g``, sparse stream = ``a.T``, whose
  plan is a metadata transpose of the forward plan
  (:func:`~repro_torch.kernels.tensordash_spmm.transpose_plan_csr`).

:func:`planned_matmul` and :func:`fused_planned_matmul` are
``torch.autograd.Function`` classes (``jax.custom_vjp`` in the JAX package): the
forward runs the backend's executor once, and the backward runs both
gradient products through the same backend registry on fp32 operands,
writing each in its operand's dtype.  The gradients are those of the math
function ``a @ b``: a plan only elides all-zero blocks.

Every product runs through the context's ``_execute``/``_execute_fused``,
which :class:`repro_torch.parallel.spmm.ShardedVJP` overrides to run it on
per-shard queues; the ``axis`` each backward product names (``da`` over
the cotangent's rows, ``db`` over its columns) is where that context
shards it.

Everything is eager, so there is no ``traced`` counter: with a plan cache
riding along, the transposed-operand plan is cached and validated against
the forward plan's ``idx`` (a static weight's plan, or the memoized dense
plan, is transposed once and replayed for every microbatch), and each
cotangent plan goes through the cache as a miss, for the counters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.tensordash_spmm import (
    _check_compact_grid,
    plan_from_mask_csr,
    transpose_plan_csr,
)
from repro_torch.runtime.plan import PlanCache, SparsityPlan, _fit_block, plan_operand

__all__ = [
    "PlannedVJP",
    "FusedVJP",
    "planned_matmul",
    "planned_matmul_grads",
    "fused_planned_matmul",
]


@dataclasses.dataclass(frozen=True)
class PlannedVJP:
    """Static context of one planned matmul's differentiation rule.

    ``backend`` executes the primal and the two backward products.
    ``cache``/``key`` route the
    backward's plans through a :class:`PlanCache`.  ``compact_grid`` is the
    grid family every product runs under by default.  ``db`` optionally
    carries a ``repro_torch.tune.TuningDB`` so each backward product
    resolves its own lane width and grid family (:meth:`_bwd_policy`).
    """

    backend: str
    bm: int
    bk: int
    bn: int
    out_dtype: Any = None
    cache: PlanCache | None = None
    key: Any = None
    compact_grid: Any = "ragged"
    db: Any = None
    split_shape: Any = None  # the primal's KernelRequest.split_shape (a slice of a larger product)

    def __post_init__(self):
        object.__setattr__(self, "compact_grid", _check_compact_grid(self.compact_grid))

    def _execute(self, nnz, idx, a, b, *, bm, bk, bn, out_dtype, workqueue=None, compact_grid=None,
                 axis=None, split_shape=None):
        """One planned product on :attr:`backend`.  ``axis`` names the dim a
        sharded context splits it along (``None``: the context's own);
        this one runs it whole."""
        from repro_torch.runtime.backends import KernelRequest, get_backend  # local: import cycle

        del axis
        return get_backend(self.backend).execute_planned(KernelRequest(
            nnz=nnz, idx=idx, a=a, b=b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype,
            compact_grid=self.compact_grid if compact_grid is None else compact_grid,
            workqueue=workqueue, split_shape=split_shape,
        ))

    def _execute_fused(self, req):
        """One fused product on :attr:`backend`: ``(out, mask)``."""
        from repro_torch.runtime.backends import get_backend  # local: import cycle

        return get_backend(self.backend).execute_fused(req)

    def _plan_workqueue(self, plan: SparsityPlan, mode=None):
        """The plan's CSR triple when the ragged grid consumes it, else
        ``None``.  ``mode`` overrides the context's grid family."""
        mode = self.compact_grid if mode is None else mode
        return plan.workqueue() if mode == "ragged" else None

    def _bwd_policy(self, op, m, k, n, dtype, *, bn):
        """Tuned ``(bn, compact_grid)`` of one backward product (``op`` is
        ``"matmul_da"`` or ``"matmul_db"``), or ``(bn, None)`` (the context's
        defaults) with no DB or a cold cell.  ``bm``/``bk`` stay the
        backward plan's own, so a tuned backward is bit-identical to the
        default one."""
        if self.db is None:
            return bn, None
        pol = self.db.resolve(op=op, m=m, k=k, n=n, dtype=dtype)
        if pol is None:
            return bn, None
        return _fit_block(pol.bn, n), pol.compact_grid


def _cot_plan(ctx: PlannedVJP, g) -> SparsityPlan:
    """Plan the output-gradient stream (Eq. 2's sparse operand) by value,
    per call; through the cache when one rides along, for its counters (a
    fresh cotangent never hits)."""
    if ctx.cache is not None:
        return ctx.cache.get_or_build(("vjp_cot", ctx.key), g, ctx.bm, ctx.bn)
    return plan_operand(g, ctx.bm, ctx.bn)


def _lhs_t_plan(ctx: PlannedVJP, nnz, idx, a) -> SparsityPlan:
    """Plan of ``a.T`` (Eq. 3's sparse operand) by metadata transpose of the
    forward plan.  It depends on the forward plan alone, so a cache hit is
    validated against ``idx``: while the forward plan is replayed, its
    transpose is too."""
    key = ("vjp_lhs_t", ctx.key)
    if ctx.cache is not None:
        hit = ctx.cache.lookup(key, idx, ctx.bk, ctx.bm)
        if hit is not None:
            return hit
    nnz_t, idx_t, row_starts, work_row, work_kblk = transpose_plan_csr(nnz, idx)
    plan = SparsityPlan(
        nnz=nnz_t, idx=idx_t, bm=ctx.bk, bk=ctx.bm, shape=(a.shape[1], a.shape[0]), dtype=a.dtype,
        row_starts=row_starts, work_row=work_row, work_kblk=work_kblk,
    )
    if ctx.cache is not None:
        ctx.cache.store(key, idx, plan)
    return plan


def _grads_from(ctx: PlannedVJP, pg: SparsityPlan, nnz, idx, a, b, g_pre):
    """``da = g_pre @ b.T`` over the cotangent plan ``pg`` and ``db = a.T @
    g_pre`` over the transposed forward plan, both on fp32 operands and
    written in the operands' dtypes."""
    bn_da, cg_da = ctx._bwd_policy("matmul_da", g_pre.shape[0], g_pre.shape[1], b.shape[0], a.dtype,
                                   bn=ctx.bk)
    da = ctx._execute(
        pg.nnz, pg.idx, g_pre, b.float().T, bm=ctx.bm, bk=ctx.bn, bn=bn_da,
        out_dtype=a.dtype, workqueue=ctx._plan_workqueue(pg, cg_da), compact_grid=cg_da, axis="M",
    )
    pt = _lhs_t_plan(ctx, nnz, idx, a)
    bn_db, cg_db = ctx._bwd_policy("matmul_db", a.shape[1], a.shape[0], g_pre.shape[1], b.dtype,
                                   bn=ctx.bn)
    db = ctx._execute(
        pt.nnz, pt.idx, a.float().T, g_pre, bm=ctx.bk, bk=ctx.bm, bn=bn_db,
        out_dtype=b.dtype, workqueue=ctx._plan_workqueue(pt, cg_db), compact_grid=cg_db, axis="N",
    )
    return da, db


def planned_matmul_grads(ctx: PlannedVJP, nnz, idx, a, b, g):
    """Both cotangents ``(da, db)`` of the planned ``a @ b``, executed
    through the registry: what :func:`planned_matmul`'s backward runs,
    callable directly (manual backprop, benchmarks, cache-counter tests)."""
    g32 = g.float()
    return _grads_from(ctx, _cot_plan(ctx, g32), nnz, idx, a, b, g32)


class _PlannedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx: PlannedVJP, nnz, idx, a, b, workqueue):
        fctx.vjp = ctx
        fctx.save_for_backward(nnz, idx, a, b)
        whole = {"split_shape": ctx.split_shape} if ctx.split_shape is not None else {}
        return ctx._execute(nnz, idx, a, b, bm=ctx.bm, bk=ctx.bk, bn=ctx.bn, out_dtype=ctx.out_dtype,
                            workqueue=workqueue, **whole)

    @staticmethod
    def backward(fctx, g):
        nnz, idx, a, b = fctx.saved_tensors
        da, db = planned_matmul_grads(fctx.vjp, nnz, idx, a, b, g)
        return None, None, None, da, db, None


def planned_matmul(ctx: PlannedVJP, nnz, idx, a, b, workqueue=None):
    """Planned ``a @ b`` on ``ctx.backend`` with the sparsity-aware
    backward.  ``workqueue`` is the plan's CSR triple (ragged grid)."""
    return _PlannedMatmul.apply(ctx, nnz, idx, a, b, workqueue)


# ---------------------------------------------------------------------------
# Fused-epilogue matmul: act(a @ b + bias) + residual, with the emitted
# output mask planning the backward G stream (paper §3.7).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedVJP(PlannedVJP):
    """Context of the fused planned matmul's differentiation rule.

    ``activation`` is applied to ``a @ b + bias`` in the kernel's store
    step, then ``residual`` is added.  A ReLU-family epilogue with no
    residual zeroes the gradient wherever the emitted mask is zero, so the
    backward plans the cotangent from that mask (metadata only); otherwise
    it plans the cotangent by value, as :func:`planned_matmul` does.

    Differentiating a ReLU-family epilogue with a residual raises
    ``NotImplementedError``: ``act'`` would have to be recovered from ``out -
    residual``, which rounding and cancellation corrupt by whole gradients.
    Without a residual ``act'`` comes from the stored output: exact in fp32,
    rounded to ~2^-9 relative in bf16.
    """

    activation: str = "none"

    @property
    def mask_plans_cotangent(self) -> bool:
        return self.activation in ("relu", "squared_relu")

    def _act_grad(self, y32, g32):
        """``g * act'(pre)`` from the post-activation, pre-residual value
        ``y`` (fp32): relu' = [y > 0]; (relu^2)' = 2 sqrt(y)."""
        if self.activation == "none":
            return g32
        if self.activation == "relu":
            return g32 * (y32 > 0)
        if self.activation == "squared_relu":
            return g32 * 2.0 * torch.sqrt(y32)
        raise ValueError(self.activation)


def _mask_plan(ctx: FusedVJP, mask) -> SparsityPlan:
    """Plan the cotangent from the forward's emitted ``[Mb, Nb]`` output
    mask, metadata only; the mask's ``(bm, bn)`` is the cotangent's
    blocking for Eq. 2."""
    nnz_g, idx_g, row_starts, work_row, work_kblk = plan_from_mask_csr(mask)
    mb, nb = mask.shape
    return SparsityPlan(
        nnz=nnz_g, idx=idx_g, bm=ctx.bm, bk=ctx.bn, shape=(mb * ctx.bm, nb * ctx.bn),
        dtype=torch.float32, row_starts=row_starts, work_row=work_row, work_kblk=work_kblk,
    )


class _FusedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx: FusedVJP, nnz, idx, a, b, bias, residual, workqueue):
        from repro_torch.runtime.backends import KernelRequest  # local: import cycle

        out, mask = ctx._execute_fused(KernelRequest(
            nnz=nnz, idx=idx, a=a, b=b, bias=bias, residual=residual, bm=ctx.bm, bk=ctx.bk,
            bn=ctx.bn, activation=ctx.activation, out_dtype=ctx.out_dtype,
            compact_grid=ctx.compact_grid, workqueue=workqueue,
        ))
        fctx.vjp = ctx
        fctx.save_for_backward(nnz, idx, a, b, bias, residual, out, mask)
        fctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(fctx, g, _gmask):
        ctx: FusedVJP = fctx.vjp
        nnz, idx, a, b, bias, residual, out, mask = fctx.saved_tensors
        if residual is not None and ctx.activation != "none":
            raise NotImplementedError(
                f"differentiating a fused {ctx.activation!r} epilogue with a residual is not "
                "supported: the backward cannot exactly recover the pre-residual activation "
                "from the stored output; apply the residual outside the kernel when training "
                "through it"
            )
        g32 = g.float()
        g_pre = ctx._act_grad(out.float(), g32)
        if ctx.mask_plans_cotangent:  # no residual here: the emitted mask bounds g_pre
            pg = _mask_plan(ctx, mask)
        else:
            pg = _cot_plan(ctx, g_pre)
        da, db = _grads_from(ctx, pg, nnz, idx, a, b, g_pre)
        dbias = None if bias is None else g_pre.sum(0).to(bias.dtype)
        dres = None if residual is None else g.to(residual.dtype)
        return None, None, None, da, db, dbias, dres, None


def fused_planned_matmul(ctx: FusedVJP, nnz, idx, a, b, bias=None, residual=None, workqueue=None):
    """Planned ``act(a @ b + bias) + residual`` on ``ctx.backend``,
    returning ``(out, mask)`` with ``mask`` the emitted int8 output
    block-nonzero map (not differentiable)."""
    return _FusedMatmul.apply(ctx, nnz, idx, a, b, bias, residual, workqueue)
