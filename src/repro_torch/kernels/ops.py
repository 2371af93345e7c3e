"""Public wrappers around the TensorDash kernels (port of
``repro/kernels/ops.py``).

Execution policy lives in :class:`repro_torch.runtime.Runtime` (backend,
block geometry, plan cache, device): pass ``runtime=`` explicitly or install
one with ``with rt.use():``.  ``bm``/``bk``/``bn`` override the resolved
runtime's block geometry for one call.
"""
from __future__ import annotations

from repro_torch.kernels.tensordash_spmm import (
    dense_plan,
    plan_blocks,
    plan_from_mask,
    plan_to_mask,
    tensordash_matmul,
    tensordash_matmul_fused,
    tensordash_matmul_planned,
    transpose_plan,
)

__all__ = [
    "matmul",
    "matmul_fused",
    "matmul_grads",
    "sparse_ffn",
    "plan_blocks",
    "plan_to_mask",
    "plan_from_mask",
    "dense_plan",
    "transpose_plan",
    "tensordash_matmul",
    "tensordash_matmul_fused",
    "tensordash_matmul_planned",
]


def _resolve(runtime, bm, bk, bn):
    from repro_torch import runtime as rtm  # local: the runtime imports the kernels

    rt = rtm.resolve(runtime)
    geom = {k: v for k, v in zip(("bm", "bk", "bn"), (bm, bk, bn)) if v is not None}
    return rt.replace(**geom) if geom else rt


def matmul(a, b, *, runtime=None, bm: int | None = None, bk: int | None = None,
           bn: int | None = None):
    """``a @ b`` on the resolved runtime's kernel backend."""
    return _resolve(runtime, bm, bk, bn).matmul(a, b)


def matmul_fused(a, b, *, bias=None, residual=None, activation: str = "none",
                 assume_dense: bool = False, runtime=None, bm: int | None = None,
                 bk: int | None = None, bn: int | None = None):
    """Fused ``act(a @ b + bias) + residual`` returning ``(out, mask)``.

    The epilogue runs in the kernel's store step and ``mask`` is the emitted
    output block-nonzero map, the §3.7 backside-scheduler product that
    :func:`repro_torch.runtime.plan.plan_from_emitted_mask` turns into the
    consumer's plan without touching values."""
    return _resolve(runtime, bm, bk, bn).matmul_fused(
        a, b, bias=bias, residual=residual, activation=activation, assume_dense=assume_dense,
    )


def matmul_grads(a, b, g, *, runtime=None, bm: int | None = None, bk: int | None = None,
                 bn: int | None = None):
    """Eager sparsity-aware cotangents ``(da, db)`` of ``a @ b`` given the
    output cotangent ``g``: the backward products (paper Eq. 2-3) autograd
    runs, exposed for manual backprop and microbenchmarks (plan-cache reuse
    is live and observable here)."""
    return _resolve(runtime, bm, bk, bn).matmul_grads(a, b, g)


def sparse_ffn(x, w1, w2, *, activation: str = "relu", runtime=None, bm: int | None = None,
               bk: int | None = None, bn: int | None = None):
    """FFN whose second product exploits the dynamic sparsity the first
    one's activation produced: the framework's main consumer of the kernel.
    ReLU-family activations make ``h`` sparse the way the paper's Eq. (1)
    activations are; the kernel turns that into skipped blocks.  Token
    dimensions of ``x`` are flattened to rows."""
    return _resolve(runtime, bm, bk, bn).sparse_ffn(x, w1, w2, activation=activation)
