"""The single front door for execution policy (port of ``repro/runtime/runtime.py``).

A frozen :class:`Runtime` bundles the kernel backend, block geometry
``bm/bk/bn``, the grid family, a plan-cache handle, the dtype policy and the
device.  Pass it explicitly or install it with ``with rt.use():``;
:func:`resolve` picks explicit > ambient > default.  The default runs on the
card: ``Runtime(device="cuda", backend="cuda")``.

Block geometry is a target: :meth:`Runtime.fit` clamps each block dim to the
largest divisor of the operand dim, so small or odd operands plan at a
finer granularity instead of falling back to a dense product.  Under
``geometry="auto"`` every call resolves its measured policy from a
:class:`repro_torch.tune.TuningDB` first (:meth:`Runtime._resolved`).

Every planned product is differentiable: when autograd needs it, the
backend runs it through :mod:`repro_torch.runtime.autodiff`, and the plan
cache and tuning DB ride along into the backward, as in the JAX package.
``sharding`` carries a :class:`repro_torch.parallel.sharding.ShardingPolicy`;
:meth:`Runtime.matmul_sharded` and :meth:`Runtime.matmul_fused_sharded` run
on its mesh.  ``validate`` gates the static plan verifier
(:mod:`repro_torch.analysis.plan_check`) at every plan-cache store and, for
a plan the caller passes, at the ``matmul``/``matmul_fused`` boundary,
where a corrupt plan is replanned from the operand with a warning
(:meth:`Runtime._recovered_plan`).  :meth:`Runtime.sparse_ffn` is the FFN
whose second product runs on the plan the first one's epilogue emitted.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import warnings
from typing import Any

import torch

from repro_torch.analysis import plan_check
from repro_torch.kernels.ref import _epilogue_ref, block_any_nonzero
from repro_torch.kernels.tensordash_spmm import _check_compact_grid
from repro_torch.runtime.backends import BackendCapabilityError, KernelBackend, get_backend
from repro_torch.resilience.log import record
from repro_torch.runtime.plan import (
    PlanCache,
    SparsityPlan,
    _fit_block,
    capturing,
    dense_operand_plan,
    plan_from_emitted_mask,
    plan_operand,
)

__all__ = [
    "GEOMETRIES",
    "Runtime",
    "use",
    "current",
    "resolve",
    "default_runtime",
    "active_mesh",
    "active_policy",
    "cache_batch_axes",
    "tree_map",
]

GEOMETRIES = ("explicit", "auto")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution policy: backend + block geometry + plan cache + device.

    ``plan_cache`` is carried by handle so a serving engine's plans survive
    across steps; it is excluded from equality.  ``accum_dtype`` must be
    float32: every backend accumulates in fp32.

    ``compact_grid`` picks the kernel grid family, bit-identical outputs:
    ``"ragged"`` walks the plan's CSR work queue, ``"v2"`` bounds the K
    steps by ``max(nnz)``, ``"v1"`` issues the full gated grid.

    ``geometry="auto"`` consults :attr:`tuning_db` (a
    :class:`repro_torch.tune.TuningDB`; the discovered default DB for this
    runtime's device when not passed) at every execution method: the
    measured-best ``bm/bk/bn``/grid family for the call's ``(op,
    shape-bucket, dtype, density-bucket, platform)`` key overlays the fields
    above, and unmeasured cells fall back to them.  With a caller-provided
    plan only the lane width and grid family are tuned, since ``bm/bk`` are
    the plan's own blocking.

    ``sharding`` is a :class:`~repro_torch.parallel.sharding.ShardingPolicy`
    (mesh, axis roles, spec tables) or ``None``; :attr:`mesh` reads its
    mesh.

    ``validate`` gates the static plan verifier: ``"off"`` (default)
    trusts the planners; ``"boundary"`` runs the O(Rb) structural checks
    at every ``PlanCache`` store, ``edit_plan`` and caller-provided plan;
    ``"full"`` adds the O(entries) content checks.  A check copies the
    plan's metadata to the host, so none runs while the current CUDA stream
    captures a graph (the JAX package skips traced plans likewise); they
    run at the eager warm-up.
    """

    backend: str = "cuda"
    bm: int = 128
    bk: int = 512
    bn: int = 128
    compact_grid: Any = "ragged"
    plan_cache: PlanCache = dataclasses.field(
        default_factory=PlanCache, compare=False, repr=False
    )
    compute_dtype: Any = None  # None: keep operand dtype
    accum_dtype: Any = torch.float32
    device: Any = "cuda"
    # static plan verification level ("off" | "boundary" | "full")
    validate: str = "off"
    # "explicit" uses bm/bk/bn/compact_grid as given; "auto" overlays the
    # measured-best policy from ``tuning_db`` per call (see repro_torch.tune)
    geometry: str = "explicit"
    tuning_db: Any = dataclasses.field(default=None, compare=False, repr=False)
    sharding: Any = None  # a repro_torch.parallel.sharding.ShardingPolicy, or None

    def __post_init__(self):
        object.__setattr__(self, "compact_grid", _check_compact_grid(self.compact_grid))
        object.__setattr__(self, "device", torch.device(self.device))
        get_backend(self.backend)  # unknown names fail at construction
        if self.validate not in plan_check.LEVELS:
            raise ValueError(f"validate={self.validate!r} not one of {plan_check.LEVELS}")
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"geometry={self.geometry!r} not one of {GEOMETRIES}")
        if self.geometry == "auto" and self.tuning_db is None:
            from repro_torch.tune import default_db, platform_of  # local: tune imports runtime

            object.__setattr__(self, "tuning_db", default_db(platform_of(self.device)))
        # the cache is carried by handle; keep its gate in step with the
        # policy that owns it (replace() re-runs this on the same handle)
        self.plan_cache.validate = self.validate

    @classmethod
    def tuned(cls, db=None, *, path=None, **kw) -> "Runtime":
        """A ``geometry="auto"`` runtime resolving from ``db``, from the file
        at ``path`` (keyed to this runtime's device), or from the discovered
        default DB.  Unmeasured cells fall back to the hand-tuned defaults,
        so an empty or missing DB degrades to exactly ``Runtime(**kw)``."""
        if db is not None and path is not None:
            raise ValueError("Runtime.tuned: pass db= or path=, not both")
        if path is not None:
            from repro_torch.tune import TuningDB, platform_of  # local: tune imports runtime

            db = TuningDB.load(path, platform=platform_of(kw.get("device", "cuda")))
        return cls(geometry="auto", tuning_db=db, **kw)

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)

    @property
    def mesh(self):
        """The mesh of :attr:`sharding` (``None`` without one)."""
        return self.sharding.mesh if self.sharding is not None else None

    @property
    def kernel(self) -> KernelBackend:
        return get_backend(self.backend)

    @property
    def wants_sparse(self) -> bool:
        """Whether this runtime's backend exploits block sparsity."""
        return self.kernel.sparse

    def use(self):
        """``with rt.use():`` — install as the ambient runtime."""
        return use(self)

    # -- planning ----------------------------------------------------------
    def plan(self, a, *, key=None, side: str = "A") -> SparsityPlan:
        """Plan operand ``a`` (``side="B"``: plan ``a.T``, the weight side).
        With a ``key`` the plan is served from :attr:`plan_cache`."""
        bm = self.bm if side == "A" else self.bn
        if key is None:
            operand = a.T if side == "B" else a
            return plan_operand(operand, bm, self.bk, side=side)
        return self.plan_cache.get_or_build(key, a, bm, self.bk, side=side)

    def fit(self, a_shape, b_shape) -> "Runtime":
        """This runtime with ``bm/bk/bn`` clamped to the largest divisors of
        ``a @ b``'s dims (the plan cache handle is shared)."""
        m, k = a_shape
        n = b_shape[1]
        bm, bk, bn = _fit_block(self.bm, m), _fit_block(self.bk, k), _fit_block(self.bn, n)
        if (bm, bk, bn) == (self.bm, self.bk, self.bn):
            return self
        return self.replace(bm=bm, bk=bk, bn=bn)

    def lane(self, dim: int, block: int | None = None) -> int:
        """Fitted output-lane width: the largest divisor of ``dim`` that is
        <= the target block (:attr:`bn` unless overridden)."""
        return _fit_block(self.bn if block is None else block, dim)

    @property
    def _db(self):
        """The TuningDB this runtime resolves from: only under
        ``geometry="auto"`` (an explicit runtime never lets a DB
        second-guess its hand-set policy)."""
        return self.tuning_db if self.geometry == "auto" else None

    def _policy(self, op: str, a_shape, b_shape, dtype, *, density=None):
        """The tuned policy for one call site, or ``None`` (explicit
        geometry, no DB, or a cold cell).  A warm lookup is one memoized
        dict probe in the DB."""
        db = self._db
        if db is None:
            return None
        return db.resolve(op=op, m=a_shape[0], k=a_shape[1], n=b_shape[1], dtype=dtype,
                          density=density)

    def _resolved(self, op: str, a_shape, b_shape, dtype, *,
                  plan: SparsityPlan | None = None, density=None) -> "Runtime":
        """The geometry of one call: the tuned policy for ``op``
        (``geometry="auto"`` only) overlaid on this runtime's defaults, then
        clamped to the operand shapes.  With a caller-provided ``plan`` its
        own blocking governs ``bm/bk`` (changing them would reassociate the
        block accumulation); only the lane width and grid family are
        tuned."""
        pol = self._policy(op, a_shape, b_shape, dtype, density=density)
        rt = self
        if pol is not None:
            if plan is None:
                new = (pol.bm, pol.bk, pol.bn, pol.compact_grid)
                if new != (rt.bm, rt.bk, rt.bn, rt.compact_grid):
                    rt = rt.replace(bm=pol.bm, bk=pol.bk, bn=pol.bn,
                                    compact_grid=pol.compact_grid)
            elif (pol.bn, pol.compact_grid) != (rt.bn, rt.compact_grid):
                rt = rt.replace(bn=pol.bn, compact_grid=pol.compact_grid)
        return rt if plan is not None else rt.fit(a_shape, b_shape)

    def supports_matmul(self, a_shape, b_shape, *, side: str = "A") -> bool:
        """Can the backend run ``a @ b`` block-sparse here?  Geometry always
        fits (it clamps, see :meth:`fit`); only the platform can say no
        (``cuda`` off the card)."""
        del a_shape, b_shape, side
        try:
            self.kernel.check_platform()
        except BackendCapabilityError:
            return False
        return True

    def _recovered_plan(self, plan: SparsityPlan, operand) -> SparsityPlan:
        """Boundary recovery for a caller-provided plan (``validate`` not
        ``"off"``; skipped while a graph is captured): verify its metadata
        and, when it is corrupt, degrade loudly (a ``RuntimeWarning``, a
        ``plan-corrupt``/``replan`` event in the ambient resilience log) and
        replan from the operand's values, instead of running a schedule that
        would drop or double-count blocks.  ``operand`` is already transposed
        for ``side="B"`` (``b.T``).  The plan's own blocking is kept where it
        still divides the operand."""
        if self.validate == "off" or capturing():
            return plan
        try:
            plan_check.check_plan(plan, level=self.validate)
            return plan
        except plan_check.PlanVerificationError as e:
            warnings.warn(
                f"corrupt SparsityPlan at Runtime.matmul boundary (side={plan.side!r}, "
                f"shape={plan.shape}): {e}; replanning from operand values",
                RuntimeWarning, stacklevel=3,
            )
            record("plan-corrupt", "runtime.matmul", "replan", side=plan.side, shape=plan.shape,
                   error=str(e))
            bm = (plan.bm if plan.bm > 0 and operand.shape[0] % plan.bm == 0
                  else _fit_block(self.bm, operand.shape[0]))
            bk = (plan.bk if plan.bk > 0 and operand.shape[1] % plan.bk == 0
                  else _fit_block(self.bk, operand.shape[1]))
            return plan_operand(operand, bm, bk, side=plan.side)

    def _whole_launch(self, split_shape, side: str, op: str, dtype, density) -> tuple:
        """``split_shape`` ``(m, k, n)`` with the block geometry ``(bm, bk,
        bn)`` of the whole launch: the blocks this runtime fits to the whole
        product's shapes (``side="B"``: the weight's plan blocks its
        columns at the fitted ``bn``)."""
        m, k, n = split_shape[:3]
        if side == "B":
            w = self._resolved(op, (n, k), (k, m), dtype, density=density)
            return m, k, n, w.bn, w.bk, w.lane(n, w.bm)
        w = self._resolved(op, (m, k), (k, n), dtype, density=density)
        return m, k, n, w.bm, w.bk, w.lane(n)

    def _dtype_prologue(self, a, b):
        """Enforce the fp32 accumulator and apply the compute-dtype cast."""
        if self.accum_dtype != torch.float32:
            raise NotImplementedError(
                f"accum_dtype={self.accum_dtype}: all registered backends "
                "accumulate in float32"
            )
        if self.compute_dtype is not None:
            a = a.to(self.compute_dtype)
            b = b.to(self.compute_dtype)
        return a, b

    # -- execution ---------------------------------------------------------
    def matmul(self, a, b, *, plan: SparsityPlan | None = None, plan_key=None,
               side: str = "A", op: str = "matmul", density=None, out_dtype=None, split_shape=None):
        """``a @ b`` on this runtime's backend.

        ``side="A"`` exploits dynamic sparsity of ``a``; ``side="B"`` the
        (static, weight) sparsity of ``b``, run through the same kernel as
        ``(b.T @ a.T).T`` with ``b.T`` passed as a strided view.
        ``plan_key`` routes planning through the keyed cache.  ``op`` names
        this call site's tuning key (``geometry="auto"``); ``density``
        refines it to the operand's density bucket (``None``: ``"any"``).
        ``out_dtype`` (default ``a``'s dtype) is the stored output's dtype:
        ``torch.float32`` keeps a tensor-parallel rank's partial sum in fp32
        from bf16 operands.  ``split_shape`` ``(m, k, n)`` names the whole
        launch this product is a slice of (for ``side="B"``, of the
        transposed product ``b.T @ a.T``): the kernel splits K as that
        launch, at the blocks this runtime fits to it, would, so a
        vocab-parallel head's slice is bit-equal to the whole head's rows
        even where the slice's fitted blocks are narrower."""
        a, b = self._dtype_prologue(a, b)
        out_dtype = a.dtype if out_dtype is None else out_dtype
        kernel = self.kernel
        if not kernel.sparse and plan is None and plan_key is None:
            return kernel.matmul(a, b, bm=self.bm, bk=self.bk, bn=self.bn, out_dtype=out_dtype)
        rt = self._resolved(op, a.shape, b.shape, a.dtype, plan=plan, density=density)
        if split_shape is not None and plan is None:
            split_shape = self._whole_launch(split_shape, side, op, a.dtype, density)
        if side == "B":
            if plan is None:
                plan = rt.plan(b, key=plan_key, side="B")
            else:
                plan = self._recovered_plan(plan, b.T)
            out_t = kernel.matmul_planned(
                plan, b.T, a.T, bn=rt.lane(a.shape[0], rt.bm), out_dtype=out_dtype,
                plan_cache=self.plan_cache, plan_key=("B", plan_key),
                compact_grid=rt.compact_grid, db=self._db, **_whole(split_shape),
            )
            return out_t.T
        if plan is None:
            if plan_key is None:
                kernel.check_platform()
                plan = rt.plan(a)
            else:
                plan = rt.plan(a, key=plan_key)
        else:
            plan = self._recovered_plan(plan, a)
        return kernel.matmul_planned(
            plan, a, b, bn=rt.lane(b.shape[1]), out_dtype=out_dtype,
            plan_cache=self.plan_cache, plan_key=("A", plan_key),
            compact_grid=rt.compact_grid, db=self._db, **_whole(split_shape),
        )

    def matmul_fused(self, a, b, *, bias=None, residual=None,
                     activation: str = "none", plan: SparsityPlan | None = None,
                     plan_key=None, assume_dense: bool = False,
                     op: str = "matmul_fused", density=None):
        """Fused ``act(a @ b + bias) + residual``, returning ``(out, mask)``
        with ``mask`` the emitted int8 output block-nonzero map.
        ``assume_dense=True`` uses the all-effectual plan of ``a`` (metadata
        only) instead of planning its values.  ``op``/``density`` as in
        :meth:`matmul`."""
        a, b = self._dtype_prologue(a, b)
        kernel = self.kernel
        rt = self._resolved(op, a.shape, b.shape, a.dtype, plan=plan, density=density)
        if not kernel.sparse and plan is None and plan_key is None:
            # dense shortcut: one fp32 product + the shared epilogue; the
            # mask is a blockwise any at the geometry the planned path emits
            out32 = _epilogue_ref(a.float() @ b.float(), bias, residual, activation)
            mask = block_any_nonzero(out32, rt.bm, rt.lane(b.shape[1]))
            return out32.to(a.dtype), mask
        kernel.check_platform()
        if plan is None:
            if assume_dense:
                plan = dense_operand_plan(a.shape, a.dtype, bm=rt.bm, bk=rt.bk, device=a.device)
            else:
                plan = rt.plan(a, key=plan_key)
        else:
            plan = self._recovered_plan(plan, a)
        return kernel.matmul_fused(
            plan, a, b, bias=bias, residual=residual, activation=activation,
            bn=rt.lane(b.shape[1]), out_dtype=a.dtype,
            plan_cache=self.plan_cache, plan_key=("A", plan_key),
            compact_grid=rt.compact_grid, db=self._db,
        )

    def plan_for_fused_output(self, mask, h, w) -> SparsityPlan:
        """Consumer plan for a fused matmul's output ``h`` (about to be the
        sparse stream of ``h @ w``), built from the emitted ``mask`` alone,
        coarsened to this runtime's fitted contraction block when divisible."""
        return plan_from_emitted_mask(
            mask, h.shape, h.dtype,
            bm=h.shape[0] // mask.shape[0],
            mask_bn=h.shape[1] // mask.shape[1],
            bk=self.fit(h.shape, w.shape).bk,
        )

    def matmul_grads(self, a, b, g, *, plan: SparsityPlan | None = None, plan_key=None):
        """Sparsity-aware cotangents ``(da, db)`` of ``a @ b``: the two
        registry-executed backward products the autograd rule runs (``da =
        g @ b.T`` planned over ``g``, ``db = a.T @ g`` over the transposed
        forward plan), with plan reuse visible in :attr:`plan_cache`."""
        from repro_torch.runtime.autodiff import PlannedVJP, planned_matmul_grads

        if plan is None:
            plan = self._resolved("matmul", a.shape, b.shape, a.dtype).plan(a, key=plan_key)
        ctx = PlannedVJP(
            backend=self.backend, bm=plan.bm, bk=plan.bk, bn=self.lane(g.shape[1]),
            cache=self.plan_cache, key=("A", plan_key), compact_grid=self.compact_grid,
            db=self._db,
        )
        return planned_matmul_grads(ctx, plan.nnz, plan.idx, a, b, g)

    def matmul_sharded(self, a, b, *, axis: str = "M", plan: SparsityPlan | None = None, plan_key=None,
                       balance: bool = True):
        """Distributed planned ``a @ b`` over :attr:`sharding`'s mesh.

        Every rank passes the global operands and gets the global output;
        each runs its shard's own ragged work queue
        (:mod:`repro_torch.parallel.spmm`).  ``axis`` picks the split:
        ``"M"`` (row-parallel over the data axes, block rows dealt
        serpentine by work when ``balance``), ``"N"`` (column-parallel over
        the model axis) or ``"K"`` (contraction-parallel, an fp32 sum of
        partials).  M and N are bit-identical to :meth:`matmul`, K is
        allclose.  Differentiable on M and N, both backward products on
        per-shard queues.  Without a mesh-backed policy it runs
        :meth:`matmul`; a shape that does not divide runs unsharded."""
        from repro_torch.parallel import spmm  # local: parallel imports runtime

        policy = self.sharding
        if policy is None or policy.mesh is None:
            return self.matmul(a, b, plan=plan, plan_key=plan_key)
        a, b = self._dtype_prologue(a, b)
        rt = self._resolved("matmul", a.shape, b.shape, a.dtype, plan=plan)
        if plan is None:
            rt.kernel.check_platform()
            plan = rt.plan(a, key=plan_key)
        return spmm.sharded_matmul(
            plan, a, b, bn=rt.lane(b.shape[1]), backend=self.backend, policy=policy, axis=axis,
            balance=balance, out_dtype=a.dtype, plan_cache=self.plan_cache, plan_key=("A", plan_key),
            compact_grid=rt.compact_grid, validate=self.validate, db=self._db,
        )

    def matmul_fused_sharded(self, a, b, *, bias=None, residual=None, activation: str = "none",
                             axis: str = "M", plan: SparsityPlan | None = None, plan_key=None,
                             assume_dense: bool = False, balance: bool = True):
        """Distributed :meth:`matmul_fused`: ``(out, mask)`` in the global
        layout on every rank.  ``axis`` as in :meth:`matmul_sharded`
        (``"K"`` is refused: the epilogue cannot distribute over the sum).
        Without a mesh-backed policy it runs :meth:`matmul_fused`."""
        from repro_torch.parallel import spmm  # local: parallel imports runtime

        policy = self.sharding
        if policy is None or policy.mesh is None:
            return self.matmul_fused(a, b, bias=bias, residual=residual, activation=activation,
                                     plan=plan, plan_key=plan_key, assume_dense=assume_dense)
        a, b = self._dtype_prologue(a, b)
        rt = self._resolved("matmul_fused", a.shape, b.shape, a.dtype, plan=plan)
        rt.kernel.check_platform()
        if plan is None:
            if assume_dense:
                plan = dense_operand_plan(a.shape, a.dtype, bm=rt.bm, bk=rt.bk, device=a.device)
            else:
                plan = rt.plan(a, key=plan_key)
        return spmm.sharded_matmul_fused(
            plan, a, b, bias=bias, residual=residual, activation=activation, bn=rt.lane(b.shape[1]),
            backend=self.backend, policy=policy, axis=axis, balance=balance, out_dtype=a.dtype,
            plan_cache=self.plan_cache, plan_key=("A", plan_key), compact_grid=rt.compact_grid,
            validate=self.validate, db=self._db,
        )

    def sparse_ffn(self, x, w1, w2, *, activation: str = "relu"):
        """FFN whose second product exploits the activation sparsity the
        first one produced (the framework's main kernel consumer).

        Sparse backends default to the fused path: the first product applies
        the activation in its store step and emits the intermediate's block
        mask, from which the second product's plan is built as a metadata
        transform (:meth:`plan_for_fused_output`).  Under
        ``geometry="auto"`` a measured ``"ffn"`` policy with ``fuse=False``
        selects the unfused chain instead (the intermediate planned by
        value; fusion moves where the activation rounds, so the two agree
        within rounding, not bit for bit).  Dense backends run two plain
        products.  Token dimensions of ``x`` are flattened to rows."""
        if activation not in ("relu", "squared_relu"):
            raise ValueError(activation)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])

        def act(h32):
            h32 = torch.relu(h32)
            return (torch.square(h32) if activation == "squared_relu" else h32).to(x.dtype)

        if not self.wants_sparse:
            out = self.matmul(act(x2.float() @ w1.float()), w2)
            return out.reshape(*lead, w2.shape[-1])
        pol = self._policy("ffn", x2.shape, w1.shape, x.dtype)
        if pol is not None and not pol.fuse:
            out = self.matmul(act(self.matmul(x2, w1).float()), w2, op="ffn")
            return out.reshape(*lead, w2.shape[-1])
        h, mask = self.matmul_fused(x2, w1, activation=activation, assume_dense=True)
        out = self.matmul(h, w2, plan=self.plan_for_fused_output(mask, h, w2), op="ffn")
        return out.reshape(*lead, w2.shape[-1])

    # -- serving cache layout ---------------------------------------------
    def slot_caches(self, cfg, slots: int, max_len: int):
        """Packed decode caches with ``slots`` as the batch dimension."""
        from repro_torch.models import model as M  # local: avoid import cycle

        return M.init_cache(cfg, slots, max_len, device=self.device)

    def grow_caches(self, cfg, caches, batch: int, max_len: int):
        """Prefill caches placed at the origin of the model's canonical
        ``max_len`` cache (cast to the cache dtype)."""
        from repro_torch.models import model as M  # local: avoid import cycle

        target = M.init_cache(cfg, batch, max_len, device=self.device)

        def place(full, part):
            if full.ndim != part.ndim:
                raise ValueError(f"cache rank mismatch: {tuple(part.shape)} -> {tuple(full.shape)}")
            full[tuple(slice(0, s) for s in part.shape)].copy_(part)
            return full

        return tree_map(place, target, caches)

    def write_slot(self, cfg, caches, slot: int, part):
        """Write one request's caches (batch 1, already grown to ``max_len``)
        into batch slot ``slot``, in place; returns ``caches``."""
        axes = cache_batch_axes(cfg)

        def place(full, p, ax):
            if p.shape[ax] != 1:
                raise ValueError(
                    f"slot write expects a batch-1 cache part, got {tuple(p.shape)} "
                    f"with batch axis {ax}"
                )
            full.narrow(ax, slot, 1).copy_(p)
            return full

        return tree_map(place, caches, part, axes)


def _whole(split_shape) -> dict:
    """``split_shape`` as a keyword only when given (a backend that has no
    such keyword is never handed one)."""
    return {} if split_shape is None else {"split_shape": split_shape}


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if tree is None:
        return None
    return fn(tree, *rest)


@functools.lru_cache(maxsize=None)
def cache_batch_axes(cfg):
    """Per-leaf batch-axis index of ``cfg``'s decode-cache tree, found by
    differencing cache layouts at two batch sizes on the ``meta`` device
    (no allocation)."""
    from repro_torch.models import model as M  # local: avoid import cycle

    t2 = M.init_cache(cfg, 2, 4, device="meta")
    t3 = M.init_cache(cfg, 3, 4, device="meta")

    def ax(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diffs) != 1:
            raise ValueError(f"ambiguous batch axis: {tuple(a.shape)} vs {tuple(b.shape)}")
        return diffs[0]

    return tree_map(ax, t2, t3)


_DEFAULT = Runtime()
_ACTIVE: contextvars.ContextVar[Runtime | None] = contextvars.ContextVar(
    "repro_torch_runtime", default=None
)


@contextlib.contextmanager
def use(rt: Runtime):
    """Install ``rt`` as the ambient runtime for the enclosed block."""
    token = _ACTIVE.set(rt)
    try:
        yield rt
    finally:
        _ACTIVE.reset(token)


def current() -> Runtime | None:
    """The ambient runtime installed by :func:`use`, or ``None``."""
    return _ACTIVE.get()


def default_runtime() -> Runtime:
    return _DEFAULT


def resolve(rt: Runtime | None = None) -> Runtime:
    """Resolve the effective runtime: explicit > ambient > default."""
    if rt is not None:
        return rt
    ambient = _ACTIVE.get()
    return ambient if ambient is not None else _DEFAULT


def active_mesh(mesh=None):
    """Explicit mesh if given, else the ambient runtime's mesh (if any)."""
    if mesh is not None:
        return mesh
    ambient = _ACTIVE.get()
    return ambient.mesh if ambient is not None else None


def active_policy(policy=None):
    """Explicit policy if given, else the ambient runtime's; a mesh-less
    :class:`~repro_torch.parallel.sharding.ShardingPolicy` when neither
    exists, so callers can thread one unconditionally."""
    if policy is not None:
        return policy
    ambient = _ACTIVE.get()
    if ambient is not None and ambient.sharding is not None:
        return ambient.sharding
    from repro_torch.parallel.sharding import ShardingPolicy  # local: parallel imports runtime

    return ShardingPolicy()
