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

Sharding, plan validation and ``sparse_ffn`` wait for later slices
(ROADMAP queue 1).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any

import torch

from repro_torch.kernels.ref import _epilogue_ref, block_any_nonzero
from repro_torch.kernels.tensordash_spmm import _check_compact_grid
from repro_torch.runtime.backends import KernelBackend, get_backend
from repro_torch.runtime.plan import (
    PlanCache,
    SparsityPlan,
    _fit_block,
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
    # "explicit" uses bm/bk/bn/compact_grid as given; "auto" overlays the
    # measured-best policy from ``tuning_db`` per call (see repro_torch.tune)
    geometry: str = "explicit"
    tuning_db: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "compact_grid", _check_compact_grid(self.compact_grid))
        object.__setattr__(self, "device", torch.device(self.device))
        get_backend(self.backend)  # unknown names fail at construction
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"geometry={self.geometry!r} not one of {GEOMETRIES}")
        if self.geometry == "auto" and self.tuning_db is None:
            from repro_torch.tune import default_db, platform_of  # local: tune imports runtime

            object.__setattr__(self, "tuning_db", default_db(platform_of(self.device)))

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
               side: str = "A", op: str = "matmul", density=None):
        """``a @ b`` on this runtime's backend.

        ``side="A"`` exploits dynamic sparsity of ``a``; ``side="B"`` the
        (static, weight) sparsity of ``b``, run through the same kernel as
        ``(b.T @ a.T).T`` with ``b.T`` passed as a strided view.
        ``plan_key`` routes planning through the keyed cache.  ``op`` names
        this call site's tuning key (``geometry="auto"``); ``density``
        refines it to the operand's density bucket (``None``: ``"any"``)."""
        a, b = self._dtype_prologue(a, b)
        kernel = self.kernel
        if not kernel.sparse and plan is None and plan_key is None:
            return kernel.matmul(a, b, bm=self.bm, bk=self.bk, bn=self.bn)
        rt = self._resolved(op, a.shape, b.shape, a.dtype, plan=plan, density=density)
        if side == "B":
            if plan is None:
                plan = rt.plan(b, key=plan_key, side="B")
            out_t = kernel.matmul_planned(
                plan, b.T, a.T, bn=rt.lane(a.shape[0], rt.bm), out_dtype=a.dtype,
                compact_grid=rt.compact_grid,
            )
            return out_t.T
        if plan is None:
            if plan_key is None:
                kernel.check_platform()
                plan = rt.plan(a)
            else:
                plan = rt.plan(a, key=plan_key)
        return kernel.matmul_planned(
            plan, a, b, bn=rt.lane(b.shape[1]), out_dtype=a.dtype,
            compact_grid=rt.compact_grid,
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
        return kernel.matmul_fused(
            plan, a, b, bias=bias, residual=residual, activation=activation,
            bn=rt.lane(b.shape[1]), out_dtype=a.dtype, compact_grid=rt.compact_grid,
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
