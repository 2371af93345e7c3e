"""Kernel backends behind one registry (port of ``repro/runtime/backends.py``).

Built-ins:

* ``"dense"``     — plain fp32-accumulated product; with a plan, the plain
                    schedule executor of ``kernels/ref.py``.
* ``"reference"`` — always plans, then runs the plain schedule executor.
* ``"cuda"``      — the hand-written Hopper kernels of
                    ``kernels/csrc/tensordash_spmm.cu`` (ragged grid only).

``dense`` and ``reference`` run on whatever device their tensors lie on.
``cuda`` never hands a CUDA tensor to a plain executor: a failed build or
launch raises.  The differentiable (VJP) wrappers wait for the training
slice; ``matmul_planned``/``matmul_fused`` call the raw executors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.tensordash_spmm import (
    _check_compact_grid,
    tensordash_matmul_fused,
    tensordash_matmul_planned,
)
from repro_torch.runtime.plan import SparsityPlan

__all__ = [
    "KernelBackend",
    "KernelRequest",
    "BackendCapabilityError",
    "register_backend",
    "get_backend",
    "available_backends",
]


class BackendCapabilityError(ValueError):
    """The requested backend cannot run this op (platform / geometry)."""


@dataclasses.dataclass(frozen=True)
class KernelRequest:
    """One planned kernel invocation, as a value: plan metadata, operands,
    block geometry, the optional fused epilogue, grid family and work queue."""

    nnz: Any
    idx: Any
    a: Any
    b: Any
    bm: int
    bk: int
    bn: int
    bias: Any = None
    residual: Any = None
    activation: str = "none"
    out_dtype: Any = None
    compact_grid: Any = "ragged"
    workqueue: Any = None

    def __post_init__(self):
        object.__setattr__(self, "compact_grid", _check_compact_grid(self.compact_grid))


class KernelBackend:
    """Backend interface: capability checks + (planned) matmul execution."""

    name: str = "?"
    #: whether ``matmul`` without a plan exploits block sparsity at all
    sparse: bool = True

    def check_platform(self) -> None:
        """Raise :class:`BackendCapabilityError` if unavailable here."""

    def check_grid(self, compact_grid) -> None:
        """Raise :class:`BackendCapabilityError` for a grid family this
        backend has no kernel for."""

    def matmul(self, a, b, *, bm: int, bk: int, bn: int, out_dtype=None):
        """Unplanned ``a @ b``; ``Runtime.matmul`` calls it only for a
        backend that is not ``sparse`` (sparse ones are planned by the
        runtime and run through :meth:`execute_planned`)."""
        raise NotImplementedError

    def execute_planned(self, req: KernelRequest):
        raise NotImplementedError

    def execute_fused(self, req: KernelRequest):
        """Returns ``(out, mask)``, the emitted ``int8 [Mb, Nb]`` mask."""
        raise NotImplementedError

    def matmul_planned(self, plan: SparsityPlan, a, b, *, bn: int, out_dtype=None,
                       compact_grid="ragged"):
        """Planned ``a @ b`` (primal only in this slice)."""
        return self.execute_planned(KernelRequest(
            nnz=plan.nnz, idx=plan.idx, a=a, b=b, bm=plan.bm, bk=plan.bk, bn=bn,
            out_dtype=out_dtype, compact_grid=compact_grid,
            workqueue=plan.workqueue() if compact_grid == "ragged" else None,
        ))

    def matmul_fused(self, plan: SparsityPlan, a, b, *, bias=None, residual=None,
                     activation: str = "none", bn: int, out_dtype=None,
                     compact_grid="ragged"):
        """Planned fused ``act(a @ b + bias) + residual``; ``(out, mask)``."""
        return self.execute_fused(KernelRequest(
            nnz=plan.nnz, idx=plan.idx, a=a, b=b, bias=bias, residual=residual,
            activation=activation, bm=plan.bm, bk=plan.bk, bn=bn,
            out_dtype=out_dtype, compact_grid=compact_grid,
            workqueue=plan.workqueue() if compact_grid == "ragged" else None,
        ))


def _ref_planned(req: KernelRequest):
    # the plain executor walks the identical per-row schedule for every grid
    # family: compaction only changes *when* work is issued
    return ref.tensordash_matmul_ref(
        req.nnz, req.idx, req.a, req.b, bm=req.bm, bk=req.bk, bn=req.bn,
        out_dtype=req.out_dtype,
    )


def _ref_fused(req: KernelRequest):
    return ref.tensordash_matmul_fused_ref(
        req.nnz, req.idx, req.a, req.b, req.bias, req.residual,
        bm=req.bm, bk=req.bk, bn=req.bn, activation=req.activation,
        out_dtype=req.out_dtype,
    )


class DenseBackend(KernelBackend):
    """Plain product; given a plan it still honours the schedule."""

    name = "dense"
    sparse = False

    def matmul(self, a, b, *, bm, bk, bn, out_dtype=None):
        del bm, bk, bn
        out = ref.matmul_ref(a, b)
        return out.to(out_dtype) if out_dtype else out

    def execute_planned(self, req):
        return _ref_planned(req)

    def execute_fused(self, req):
        return _ref_fused(req)


class ReferenceBackend(KernelBackend):
    """Block-sparse reference: plan + plain schedule execution."""

    name = "reference"

    def execute_planned(self, req):
        return _ref_planned(req)

    def execute_fused(self, req):
        return _ref_fused(req)


class CudaBackend(KernelBackend):
    """The TensorDash kernels for Hopper (compute capability 9.x)."""

    name = "cuda"

    def check_platform(self):
        if not torch.cuda.is_available():
            raise BackendCapabilityError(
                "cuda: requires an NVIDIA GPU of compute capability 9.x (none "
                "visible); use 'reference' or 'dense' on the CPU"
            )
        major, minor = torch.cuda.get_device_capability()
        if major != 9:
            raise BackendCapabilityError(
                f"cuda: kernels are built for sm_90a, found compute capability {major}.{minor}"
            )

    def check_grid(self, compact_grid):
        if _check_compact_grid(compact_grid) != "ragged":
            raise BackendCapabilityError(
                f"cuda: compact_grid={compact_grid!r} has no CUDA kernel yet; only "
                "'ragged' is ported (v2/v1 are ROADMAP queue 2, items 4-5)"
            )

    def _check(self, req: KernelRequest):
        self.check_platform()
        self.check_grid(req.compact_grid)
        if req.a.device.type != "cuda":
            raise BackendCapabilityError(f"cuda: operands lie on {req.a.device}, not on the card")

    def execute_planned(self, req):
        self._check(req)
        return tensordash_matmul_planned(
            req.nnz, req.idx, req.a, req.b, bm=req.bm, bk=req.bk, bn=req.bn,
            out_dtype=req.out_dtype, compact_grid=req.compact_grid,
            workqueue=req.workqueue,
        )

    def execute_fused(self, req):
        self._check(req)
        return tensordash_matmul_fused(
            req.nnz, req.idx, req.a, req.b, req.bias, req.residual,
            activation=req.activation, bm=req.bm, bk=req.bk, bn=req.bn,
            out_dtype=req.out_dtype, compact_grid=req.compact_grid,
            workqueue=req.workqueue,
        )


_REGISTRY: dict[str, KernelBackend] = {}


def register_backend(backend: KernelBackend) -> KernelBackend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> KernelBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel backend {name!r}; registered: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


register_backend(DenseBackend())
register_backend(ReferenceBackend())
register_backend(CudaBackend())
