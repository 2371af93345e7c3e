"""Plain PyTorch executors and numpy oracles (port of ``repro/kernels/ref.py``).

``tensordash_matmul_ref`` and ``tensordash_matmul_fused_ref`` walk exactly
the block schedule the kernels walk: per block row, the planned K blocks in
plan order, each block's product taken in fp32 and added to an fp32
accumulator, then the (fused) epilogue and the cast.  They are the
``dense``/``reference`` backends' executors and the plain versions the CUDA
kernels are held against on the card.  The planner's plain versions
(:func:`plan_blocks_csr_ref`, :func:`plan_from_mask_csr_ref`,
:func:`transpose_plan_csr_ref`) are the chains of small torch ops the
one-launch planner kernel replaces: a block-nonzero mask compacted by a
cumsum and a scatter into ``(nnz, idx)``, flattened into the CSR work queue.
They run on whatever device their inputs lie on.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "matmul_ref",
    "plan_blocks_ref",
    "plan_workqueue_ref",
    "block_any_nonzero",
    "mask_to_plan_ref",
    "workqueue_ref",
    "plan_to_mask_ref",
    "plan_blocks_csr_ref",
    "plan_from_mask_csr_ref",
    "transpose_plan_csr_ref",
    "tensordash_matmul_ref",
    "tensordash_matmul_fused_ref",
    "matmul_grads_ref",
    "sparse_ffn_ref",
]


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense oracle: fp32 product, cast back to ``a``'s dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def plan_blocks_ref(a: np.ndarray, bm: int, bk: int):
    """Reference (loopy numpy) block plan for property tests."""
    m, k = a.shape
    mb, kb = m // bm, k // bk
    nnz = np.zeros(mb, np.int32)
    idx = np.zeros((mb, kb), np.int32)
    for mi in range(mb):
        eff = [
            ki
            for ki in range(kb)
            if np.any(a[mi * bm : (mi + 1) * bm, ki * bk : (ki + 1) * bk] != 0)
        ]
        nnz[mi] = len(eff)
        row = eff + [eff[-1] if eff else 0] * (kb - len(eff))
        idx[mi] = row
    return nnz, idx


def plan_workqueue_ref(nnz: np.ndarray, idx: np.ndarray):
    """Reference (loopy numpy) CSR work queue: one item per effectual block
    in row-major plan order, all-zero rows keeping one gated placeholder."""
    mb, kb = idx.shape
    row_starts = np.zeros(mb + 1, np.int32)
    work_row = np.zeros(mb * kb, np.int32)
    work_kblk = np.zeros(mb * kb, np.int32)
    t = 0
    for m in range(mb):
        row_starts[m] = t
        for j in range(max(int(nnz[m]), 1)):
            work_row[t] = m
            work_kblk[t] = idx[m, j]
            t += 1
    row_starts[mb] = t
    return row_starts, work_row, work_kblk


def _check_blocks(a, b, bm: int, bk: int, bn: int):
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if m % bm or k % bk or n % bn:
        raise ValueError(
            f"shapes {tuple(a.shape)} @ {tuple(b.shape)} not divisible by "
            f"blocks bm={bm} bk={bk} bn={bn}"
        )
    return m, k, n


def _planned_acc(nnz, idx, a, b, bm: int, bk: int) -> torch.Tensor:
    """The fp32 accumulator ``[M, N]`` of the planned schedule."""
    m, k = a.shape
    n = b.shape[1]
    mb, kb = m // bm, k // bk
    nnz = torch.as_tensor(nnz, device=a.device).long()
    idx = torch.as_tensor(idx, device=a.device).long()
    abl = a.reshape(mb, bm, kb, bk).permute(0, 2, 1, 3)  # [Mb, Kb, bm, bk]
    bbl = b.reshape(kb, bk, n)  # [Kb, bk, N]
    rows = torch.arange(mb, device=a.device)
    acc = torch.zeros((mb, bm, n), dtype=torch.float32, device=a.device)
    for j in range(kb):  # plan order, same accumulation sequence as the kernel
        ki = idx[:, j]
        part = torch.bmm(abl[rows, ki].float(), bbl[ki].float())
        acc = acc + torch.where((j < nnz)[:, None, None], part, 0.0)
    return acc.reshape(m, n)


def tensordash_matmul_ref(nnz, idx, a, b, *, bm: int, bk: int, bn: int, out_dtype=None):
    """Plan-driven block-sparse ``a @ b``: per block row, accumulate the
    planned K blocks in plan order into an fp32 accumulator, then cast to
    ``out_dtype`` (the operands' dtype by default; bf16 from fp32 operands
    rounds once, fp32 from bf16 operands keeps the accumulator, as the
    kernel's three store types do)."""
    _check_blocks(a, b, bm, bk, bn)
    return _planned_acc(nnz, idx, a, b, bm, bk).to(out_dtype or a.dtype)


def _epilogue_ref(acc, bias, residual, activation: str):
    """The fp32 epilogue of the fused kernel's store step: bias ->
    activation -> residual.  Eager ops, so the square and the residual add
    round separately (no FMA contraction)."""
    out = acc
    if bias is not None:
        out = out + bias.float()[None, :]
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    elif activation == "squared_relu":
        out = torch.square(torch.clamp_min(out, 0.0))
    elif activation != "none":
        raise ValueError(activation)
    if residual is not None:
        out = out + residual.float()
    return out


def block_any_nonzero(x32: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """int8 ``[M/bm, N/bn]``: 1 where a block of ``x32`` has any nonzero."""
    m, n = x32.shape
    nz = x32.reshape(m // bm, bm, n // bn, bn) != 0
    return nz.any(dim=3).any(dim=1).to(torch.int8)


_I32 = torch.int32


def mask_to_plan_ref(nonzero: torch.Tensor):
    """Compact a block-nonzero mask ``[Mb, Kb]`` into ``(nnz, idx)``: a
    cumsum gives each effectual block its slot, a scatter writes it
    (ineffectual blocks land in a dropped extra column), and the tail repeats
    the last effectual index."""
    nonzero = nonzero != 0
    mb, kb = nonzero.shape
    dev = nonzero.device
    nnz = nonzero.sum(dim=1, dtype=_I32)
    slot = torch.cumsum(nonzero, dim=1, dtype=_I32) - 1
    target = torch.where(nonzero, slot, kb).long()
    ks = torch.arange(kb, dtype=_I32, device=dev).expand(mb, kb)
    idx = torch.zeros((mb, kb + 1), dtype=_I32, device=dev).scatter_(1, target, ks)[:, :kb]
    pos = torch.arange(kb, device=dev)[None, :]
    last = idx.gather(1, torch.clamp_min(nnz - 1, 0).long()[:, None])
    idx = torch.where(pos < torch.clamp_min(nnz, 1)[:, None], idx, last)
    return nnz, idx.contiguous()


def workqueue_ref(nnz: torch.Tensor, idx: torch.Tensor):
    """Flatten ``(nnz, idx)`` into the v3 CSR work queue ``(row_starts
    [Mb+1], work_row [Mb*Kb], work_kblk [Mb*Kb])`` with torch ops (the
    loopy numpy oracle is :func:`plan_workqueue_ref`).  Every row owns
    ``max(nnz, 1)`` items, so an all-zero row keeps one gated item; the tail
    past ``row_starts[-1]`` is zero and never visited."""
    mb, kb = idx.shape
    dev = idx.device
    flat = mb * kb
    work = torch.clamp_min(nnz, 1).to(_I32)
    row_starts = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                            torch.cumsum(work, dim=0, dtype=_I32)])
    j = torch.arange(kb, dtype=_I32, device=dev)[None, :]
    pos = torch.where(j < work[:, None], row_starts[:-1, None] + j, flat).long().reshape(-1)
    rows = torch.arange(mb, dtype=_I32, device=dev)[:, None].expand(mb, kb).reshape(-1)

    def scatter(values):
        buf = torch.zeros(flat + 1, dtype=_I32, device=dev)
        return buf.scatter_(0, pos, values)[:flat]

    return row_starts, scatter(rows), scatter(idx.to(_I32).reshape(-1))


def plan_to_mask_ref(nnz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The block-nonzero mask ``[Mb, Kb]`` (bool) a plan was compacted from."""
    mb, kb = idx.shape
    valid = (torch.arange(kb, device=idx.device)[None, :] < nnz[:, None]).to(torch.int8)
    mask = torch.zeros((mb, kb), dtype=torch.int8, device=idx.device)
    return mask.scatter_reduce_(1, idx.long(), valid, reduce="amax") != 0


def _csr(nnz, idx):
    return (nnz, idx) + workqueue_ref(nnz, idx)


def plan_blocks_csr_ref(a: torch.Tensor, bm: int, bk: int):
    """The CSR plan ``(nnz, idx, row_starts, work_row, work_kblk)`` of
    ``a``'s effectual ``bm x bk`` blocks."""
    return _csr(*mask_to_plan_ref(block_any_nonzero(a, bm, bk)))


def plan_from_mask_csr_ref(mask: torch.Tensor, *, coarsen: int = 1):
    """The CSR plan of an emitted ``[Mb, Nb]`` mask, ``coarsen`` adjacent
    columns to a K block (effectual iff any member is)."""
    mb, nb = mask.shape
    nonzero = mask != 0
    if coarsen > 1:
        nonzero = nonzero.reshape(mb, nb // coarsen, coarsen).any(dim=2)
    return _csr(*mask_to_plan_ref(nonzero))


def transpose_plan_csr_ref(nnz: torch.Tensor, idx: torch.Tensor):
    """The CSR plan of ``a.T`` from the plan ``(nnz, idx)`` of ``a``: the
    transposed block mask, compacted."""
    return _csr(*mask_to_plan_ref(plan_to_mask_ref(nnz, idx).T))


def tensordash_matmul_fused_ref(nnz, idx, a, b, bias=None, residual=None, *,
                                bm: int, bk: int, bn: int,
                                activation: str = "none", out_dtype=None):
    """Plan-driven fused ``act(a @ b + bias) + residual`` plus the emitted
    ``int8 [Mb, Nb]`` output block-nonzero mask, computed on the fp32
    epilogue value before the cast."""
    _check_blocks(a, b, bm, bk, bn)
    out32 = _epilogue_ref(_planned_acc(nnz, idx, a, b, bm, bk), bias, residual, activation)
    return out32.to(out_dtype or a.dtype), block_any_nonzero(out32, bm, bn)


def matmul_grads_ref(a, b, g):
    """Dense-math cotangents of ``a @ b`` (fp32 products, operand dtypes
    restored): the oracle of the planned backward, whose products only skip
    all-zero blocks of ``g`` and ``a.T``."""
    g32 = g.float()
    da = (g32 @ b.float().T).to(a.dtype)
    db = (a.float().T @ g32).to(b.dtype)
    return da, db


def sparse_ffn_ref(x, w1, w2, activation="relu"):
    """Dense FFN oracle ``act(x @ w1) @ w2`` (fp32 products, the
    intermediate cast to ``x``'s dtype); ``relu`` or ``squared_relu``."""
    h = x.float() @ w1.float()
    if activation == "relu":
        h = torch.relu(h)
    elif activation == "squared_relu":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(activation)
    return (h.to(x.dtype).float() @ w2.float()).to(x.dtype)
