"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro/optim/adamw.py``).

Moments are fp32 whatever the parameter dtype (bf16 parameters with an fp32
optimizer, the usual mixed-precision recipe).  Unlike the JAX version,
which returns new arrays, :func:`apply_updates` updates the parameters and
the moments **in place** under ``torch.no_grad()``: no second copy of the
model or of its optimizer state is made, and every parameter stays the same
tensor object, so a plan keyed by a weight (the LM head's) is found again
and, since the update bumped the weight's version, rebuilt rather than
replayed stale (:class:`repro_torch.runtime.PlanCache`).  The step counter,
the learning rate and the bias corrections are host scalars computed in
float32, as the JAX version computes them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.runtime.runtime import tree_map

__all__ = ["OptConfig", "OptState", "init_opt_state", "apply_updates", "global_norm", "lr_at",
           "tree_leaves", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: int  # updates applied so far
    m: dict  # fp32 first moments, the parameters' tree
    v: dict  # fp32 second moments


def tree_leaves(tree) -> list:
    """The tensors of nested dicts (keys sorted, as ``jax.tree.leaves``
    orders them) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """``like``'s nested dicts and lists with its tensors replaced, in
    :func:`tree_leaves` order, by ``leaves`` (for example gradients)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree, *, shards=None, specs=None) -> torch.Tensor:
    """``sqrt(sum(x^2))`` over every leaf, in fp32, on the leaves' device.

    On a mesh (``shards``, a :class:`~repro_torch.parallel.sharding.
    ModelShards`, with ``specs`` the leaves' spec tuples in
    :func:`tree_leaves` order) the leaves are this rank's shards: the sum
    runs over the whole mesh, each replicated slice counted once (by the
    first rank holding it), so every rank gets the global norm."""
    leaves = tree_leaves(tree)
    if shards is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    from repro_torch.parallel import sharding as S  # local: parallel imports runtime

    own = S.owner_mask(specs, shards)
    total = sum(torch.sum(torch.square(x.float())) for x, mine in zip(leaves, own) if mine)
    total = total if isinstance(total, torch.Tensor) else torch.zeros((), device=leaves[0].device)
    return torch.sqrt(S.mesh_all_reduce(total, shards))


def lr_at(cfg: OptConfig, step: int) -> float:
    """Learning rate at ``step`` (linear warmup, then cosine to
    ``min_lr_ratio``), computed in float32."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(cfg.min_lr_ratio) + f((1 - cfg.min_lr_ratio) * 0.5) * (f(1.0) + np.cos(f(np.pi) * t))
    return float(f(f(cfg.lr) * warm) * cos)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig, *, gnorm=None):
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the same ``params`` tree (its tensors updated), the state with the step
    counter advanced (its moment tensors updated), and ``grad_norm`` (a
    device scalar, before clipping) and ``lr``.  ``gnorm`` is the gradient
    norm to clip by (default :func:`global_norm` of ``grads``; a sharded
    step passes the global norm of its shards, and each rank updates its
    own shards)."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, OptState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
