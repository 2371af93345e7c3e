"""Training-time sparsity inducers (port of ``repro/optim/sparsify.py``;
paper §1: TensorDash's benefits are amplified by methods that prune,
quantise or selectively backpropagate).

* :func:`prune_schedule` + :class:`PruneState` — gradual magnitude pruning
  (Zhu & Gupta cubic ramp) with periodic mask refresh.  The ramp is
  computed in float32 with the JAX package's operation order, so the
  dynamic-sparsity controller lands on the same block budgets.
* :func:`pact` — PACT activation clipping + k-bit quantisation with a
  straight-through estimator; values clipped to zero become TensorDash-
  exploitable exact zeros.
* :func:`meprop` — selective backprop: keep only the top-k-magnitude
  gradient entries per row (meProp); the discarded gradient entries are
  exact zeros in G_O, the paper's third sparsity source.

The straight-through round and meProp are ``torch.autograd.Function``\\ s
(the JAX package's ``custom_vjp``\\ s).  For RigL-style dynamic sparse
training at the kernel's block granularity see
:mod:`repro_torch.sparse_train`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.runtime.runtime import tree_map

__all__ = ["PruneState", "prune_schedule", "init_prune", "refresh_masks", "apply_masks", "pact", "meprop"]


def prune_schedule(step, target: float, begin: int, end: int) -> np.float32:
    """Cubic sparsity ramp: 0 at ``begin`` -> ``target`` at ``end``, in
    float32 (host scalars)."""
    f = np.float32
    t = np.clip(f(step - begin) / f(max(end - begin, 1)), f(0.0), f(1.0))
    u = f(1.0) - t
    return f(target) * (f(1.0) - u * u * u)


class PruneState(NamedTuple):
    masks: dict  # tree of bool masks (True = keep)


def init_prune(params) -> PruneState:
    return PruneState(masks=tree_map(lambda p: torch.ones(p.shape, dtype=torch.bool, device=p.device), params))


@torch.no_grad()
def _mask_one(p, sparsity):
    """Keep exactly the largest-|p| ``n - floor(sparsity * n)`` entries.

    ``torch.topk`` finds the kept count's smallest magnitude; entries above
    it are kept and the ties at it are filled toward the lower flat index,
    the order ``jax.lax.top_k`` keeps, so the kept count is exact and the
    mask is the JAX package's even when values tie at the cut.
    """
    flat = torch.abs(p.float()).reshape(-1)
    n = flat.numel()
    keep = n - min(max(int(float(sparsity) * n), 0), n - 1)
    kth = torch.topk(flat, keep, sorted=False).values.min()
    mask = flat > kth
    tied = torch.nonzero(flat == kth).reshape(-1)
    mask[tied[: keep - int(mask.sum())]] = True
    return mask.reshape(p.shape)


def refresh_masks(params, sparsity, *, min_size: int = 256) -> PruneState:
    """Recompute magnitude masks at the scheduled sparsity (dynamic sparse
    reparameterization: pruned weights may regrow on later refreshes since
    masks are recomputed from current magnitudes, not intersected).
    Stateless: masks are a pure function of the current magnitudes."""
    masks = tree_map(
        lambda p: _mask_one(p, sparsity) if p.numel() >= min_size and p.ndim >= 2
        else torch.ones(p.shape, dtype=torch.bool, device=p.device),
        params,
    )
    return PruneState(masks=masks)


def apply_masks(params, state: PruneState):
    """``params`` times their masks (new tensors)."""
    return tree_map(lambda p, m: p * m.to(p.dtype), params, state.masks)


class _SteRound(torch.autograd.Function):
    """``round`` (half to even) forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def pact(x, alpha, bits: int = 4):
    """PACT: clip to [0, alpha], quantise to ``bits`` levels (STE).

    Sub-LSB values quantise to exactly zero — the quantisation-induced
    sparsity TensorDash exploits (paper §1, PACT/LQ-Nets discussion).  The
    clip is ``minimum(maximum(x, 0), alpha)``, whose gradient splits evenly
    at a tie, as ``jnp.clip``'s does.
    """
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    levels = 2**bits - 1
    y = torch.minimum(torch.maximum(x, torch.zeros_like(x)), alpha)
    return _SteRound.apply(y / alpha * levels) * (alpha / levels)


class _MeProp(torch.autograd.Function):
    """Identity forward; backward keeps, per leading-axis row, the gradient
    entries at least as large as the row's ``k``-th largest magnitude."""

    @staticmethod
    def forward(ctx, x, k: int):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mag = torch.abs(g)
        kth = torch.topk(mag.reshape(g.shape[0], -1), ctx.k).values[:, -1]
        kth = kth.reshape((g.shape[0],) + (1,) * (g.ndim - 1))
        return torch.where(mag >= kth, g, torch.zeros_like(g)), None


def meprop(x, k: int):
    """meProp: ``x`` forward, the top-``k`` gradient entries per row back."""
    return _MeProp.apply(x, k)
