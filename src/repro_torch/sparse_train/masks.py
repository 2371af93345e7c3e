"""Block-structured weight masks at the runtime's plan geometry (port of
``repro/sparse_train/masks.py``).

The subsystem's load-bearing invariant: every weight mask is a *block* mask
at exactly the ``(bk, bn)`` granularity the ambient
:class:`~repro_torch.runtime.Runtime` plans ``side="B"`` matmuls with.  A
masked weight therefore has entirely-zero blocks wherever the mask is off,
so the value planner (``plan_blocks_csr``, one planner launch on the card)
recovers the controller's mask *by construction* — the forward kernel, the
sparsity-aware backward products and the controller's host-side CSR
metadata all see one schedule, with no separate mask plumbing into the
model.

**Paths are the JAX package's.**  JAX stacks each per-layer weight along a
leading ``[L, ...]`` axis and keys a controlled leaf by
``jax.tree_util.keystr`` of that stacked leaf; the port keeps one dict per
layer (``params["layers"]`` is a list).  :func:`stacked_leaves` maps every
leaf of a list of layers to the JAX path of the stacked leaf (for example
``"['layers']['mlp']['w_gate']"``) with its ``[L, ...]`` shape, so
:func:`maskable` sees the JAX shapes, and masks, scores and the
``("dst", path, layer, ...)`` plan-cache keys are the JAX package's own.
Masks are weight-oriented ``[*lead, K/bk', N/bn']`` boolean tensors over the
stacked shape; layer ``l`` of a stacked path is index ``l`` of the mask's
element expansion (for a per-layer matrix its lead slice, for a per-layer
vector such as a norm gain one row of the ``[L, d]`` matrix JAX masks).

Masking is **in place**: the train step updates parameters in place, and an
in-place write bumps a tensor's ``_version``, which is how the LM-head plan
cache notices a re-masked weight and replans it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "StackedLeaf",
    "stacked_leaves",
    "maskable",
    "expand_block_mask",
    "apply_block_masks",
    "block_abs_sum",
    "block_scores",
    "mask_density",
    "mask_paths",
]


class StackedLeaf(NamedTuple):
    """The tensors behind one JAX path: one per layer when ``stacked``
    (a leaf of ``params["layers"][l]``), else the single tensor."""

    leaves: list
    stacked: bool

    @property
    def shape(self) -> tuple:
        """The JAX package's shape of this leaf (``[L, ...]`` when stacked)."""
        head = self.leaves[0].shape
        return (len(self.leaves), *head) if self.stacked else tuple(head)

    @property
    def dtype(self):
        return self.leaves[0].dtype


def stacked_leaves(tree) -> dict[str, StackedLeaf]:
    """``{JAX keystr path: StackedLeaf}`` of every tensor of a port tree, in
    the JAX package's (sorted-key) order.  A list is a stack of layers: its
    elements' leaves share their path."""
    out: dict[str, StackedLeaf] = {}

    def walk(t, path: str, stacked: bool):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}[{k!r}]", stacked)
        elif isinstance(t, list):
            if stacked:
                raise ValueError(f"{path}: nested layer lists have no JAX counterpart")
            for x in t:
                walk(x, path, True)
        elif t is not None:
            out.setdefault(path, StackedLeaf([], stacked)).leaves.append(t)

    walk(tree, "", False)
    return out


def maskable(path: str, p, *, min_size: int = 256, exclude=()) -> bool:
    """Whether leaf ``p`` (anything with the JAX package's ``shape``) at
    tree path ``path`` participates in dynamic sparsity: a 2-D-or-stacked
    weight matrix, big enough to matter, and not an excluded family."""
    shape = tuple(p.shape)
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return False
    if shape[-1] * shape[-2] < min_size:
        return False
    return not any(tok in path for tok in exclude)


def mask_paths(params, *, min_size: int = 256, exclude=()) -> dict[str, StackedLeaf]:
    """``{keystr path: StackedLeaf}`` of every maskable weight in ``params``."""
    return {
        path: leaf
        for path, leaf in stacked_leaves(params).items()
        if maskable(path, leaf, min_size=min_size, exclude=exclude)
    }


def expand_block_mask(mask, block: tuple[int, int]):
    """Broadcast a ``[*lead, Kb, Nb]`` block mask to element granularity
    ``[*lead, Kb*bk, Nb*bn]`` (a reshape/broadcast; no gather)."""
    bk, bn = block
    kb, nb = mask.shape[-2], mask.shape[-1]
    lead = tuple(mask.shape[:-2])
    m = mask.reshape(*lead, kb, 1, nb, 1).expand(*lead, kb, bk, nb, bn)
    return m.reshape(*lead, kb * bk, nb * bn)


@torch.no_grad()
def block_abs_sum(x, block: tuple[int, int]):
    """Per-block L1 mass of ``x [*lead, K, N]`` -> ``[*lead, Kb, Nb]`` fp32
    — the magnitude score RigL prunes on (weights) and regrows on
    (gradients), at the same granularity the mask lives at."""
    bk, bn = block
    k, n = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    blocks = torch.abs(x.float()).reshape(*lead, k // bk, bk, n // bn, bn)
    return blocks.sum(dim=(-3, -1))


def _leaf_scores(leaf: StackedLeaf, block) -> torch.Tensor:
    """``block_abs_sum`` of the stacked leaf: layer by layer for stacked
    matrices (no stacked copy), over the stacked tensor otherwise."""
    if leaf.stacked and len(leaf.leaves[0].shape) >= 2:
        return torch.stack([block_abs_sum(x, block) for x in leaf.leaves])
    x = torch.stack(leaf.leaves) if leaf.stacked else leaf.leaves[0]
    return block_abs_sum(x, block)


@torch.no_grad()
def block_scores(tree, spec: dict) -> dict:
    """``{path: block_abs_sum(stacked leaf)}`` for every controlled leaf of
    ``tree`` — applied to masked params it yields the controller's prune
    scores, to pre-mask grads its regrow scores (RigL's dense gradients)."""
    leaves = stacked_leaves(tree)
    return {path: _leaf_scores(leaves[path], spec[path]) for path in spec if path in leaves}


@torch.no_grad()
def mask_density(masks: dict, spec: dict):
    """Element-weighted live density of the mask set (a device scalar)."""
    num = sum(masks[p].sum() * (spec[p][0] * spec[p][1]) for p in masks)
    den = sum(masks[p].numel() * spec[p][0] * spec[p][1] for p in masks)
    return num.float() / max(den, 1)


def _mask_matrix_(x, mask, block) -> None:
    """``x [*, K, N] *= expand(mask [*, Kb, Nb])``, in place, blockwise."""
    bk, bn = block
    kb, nb = mask.shape[-2], mask.shape[-1]
    lead = tuple(mask.shape[:-2])
    m = mask.to(device=x.device, dtype=x.dtype)
    if x.is_contiguous():
        x.view(*lead, kb, bk, nb, bn).mul_(m.reshape(*lead, kb, 1, nb, 1))
    else:
        x.mul_(expand_block_mask(m, block))


@torch.no_grad()
def apply_block_masks(params, masks: dict, spec: dict):
    """Zero the masked-off blocks of every controlled weight, in place, and
    return ``params``.

    ``masks`` maps keystr paths to ``[*lead, Kb, Nb]`` boolean block masks
    over the JAX package's stacked shape; ``spec`` maps the same paths to
    their ``(bk, bn)`` block geometry (``DynamicSparsityController.spec()``).
    Uncontrolled leaves are untouched.  Works on gradients too (pass them
    in the parameters' structure) — masking grads before the optimizer is
    what pins pruned weights (and their Adam moments' updates) at zero
    between refreshes.
    """
    leaves = stacked_leaves(params)
    for path, mask in masks.items():
        leaf = leaves[path]
        if not leaf.stacked:
            _mask_matrix_(leaf.leaves[0], mask, spec[path])
        elif len(leaf.leaves[0].shape) >= 2:
            for x, m in zip(leaf.leaves, mask):
                _mask_matrix_(x, m, spec[path])
        else:  # per-layer vectors: layer l is row l of the [L, d] matrix
            em = expand_block_mask(mask, spec[path])
            for x, m in zip(leaf.leaves, em):
                x.mul_(m.to(device=x.device, dtype=x.dtype))
    return params
