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

**On a mesh** a rank holds slices of the leaves (``parallel/sharding.py``),
while masks, block geometry and scores stay the global leaves' (the JAX
package's).  A :class:`Cut` per path says where the rank's tensors sit in
the global leaf; :func:`apply_block_masks` and :func:`block_scores` take the
``cuts`` (:func:`leaf_cuts`) and work on the rank's slices: a slice may
start or end inside a mask block (``d_ff`` 11008 at block 128 over 4 ranks
gives each 21.5 blocks), so local row ``i`` lies in block ``(offset + i) //
bk`` and the rank's scores are partial block sums, scattered into a
global-shaped tensor that sums over the ranks to the global scores.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import shard_extent

__all__ = [
    "StackedLeaf",
    "stacked_leaves",
    "Cut",
    "leaf_cuts",
    "shard_block_mask",
    "shard_block_scores",
    "maskable",
    "expand_block_mask",
    "local_masks",
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


class Cut(NamedTuple):
    """Where a rank's tensors of one path sit in the JAX package's global
    leaf: the global (stacked) ``shape`` and the element ``offsets`` of the
    rank's slice on each of its dims (0 on a stacked leaf's layer axis)."""

    shape: tuple
    offsets: tuple


def leaf_cuts(params, specs, index_of) -> dict[str, Cut]:
    """``{path: Cut}`` of every leaf of a tree of a rank's shards, from the
    spec tuples ``specs`` it was cut under (the same tree) and ``index_of``
    (``parallel.sharding.rank_index(policy)``, or any ``entry -> (count,
    index)``, which needs no process group)."""
    spec_of = stacked_leaves(specs)
    out = {}
    for path, leaf in stacked_leaves(params).items():
        shape, offsets = shard_extent(tuple(leaf.leaves[0].shape), spec_of[path].leaves[0], index_of)
        out[path] = Cut((len(leaf.leaves), *shape), (0, *offsets)) if leaf.stacked else Cut(shape, offsets)
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


@torch.no_grad()
def shard_block_scores(x, block: tuple[int, int], offsets: tuple, shape: tuple):
    """A rank's partial block scores: the per-block L1 mass of its slice
    ``x`` of a global ``[*lead, K, N]`` tensor of ``shape``, the slice
    starting at element ``offsets``, scattered into a global-shaped
    ``[*lead, K/bk, N/bn]`` fp32 tensor (zero outside the slice's blocks).
    Block L1 mass is additive, so the ranks' partials sum to
    :func:`block_abs_sum` of the global tensor; a block the slice cuts gets
    the part of its mass the slice holds.  The slice whole returns
    ``block_abs_sum(x)``."""
    if tuple(x.shape) == tuple(shape):
        return block_abs_sum(x, block)
    bk, bn = block
    *lead_at, k0, n0 = offsets
    *lead, k, n = x.shape
    hk, hn = k0 % bk, n0 % bn
    kb, nb = -(-(hk + k) // bk), -(-(hn + n) // bn)
    # pad the slice out to whole blocks: zeros add nothing to a block's mass
    a = F.pad(torch.abs(x.float()), (hn, nb * bn - hn - n, hk, kb * bk - hk - k))
    part = block_abs_sum(a, block)
    out = part.new_zeros((*shape[:-2], shape[-2] // bk, shape[-1] // bn))
    at = tuple(slice(o, o + s) for o, s in zip(lead_at, lead))
    out[(*at, slice(k0 // bk, k0 // bk + kb), slice(n0 // bn, n0 // bn + nb))] = part
    return out


def _leaf_scores(leaf: StackedLeaf, block, cut: Cut | None) -> torch.Tensor:
    """``block_abs_sum`` of the stacked leaf (a rank's partial scores of it
    under ``cut``): layer by layer for stacked matrices (no stacked copy),
    over the stacked tensor otherwise."""
    if cut is None:
        cut = Cut(leaf.shape, (0,) * len(leaf.shape))
    if leaf.stacked and len(leaf.leaves[0].shape) >= 2:
        return torch.stack([shard_block_scores(x, block, cut.offsets[1:], cut.shape[1:]) for x in leaf.leaves])
    x = torch.stack(leaf.leaves) if leaf.stacked else leaf.leaves[0]
    return shard_block_scores(x, block, cut.offsets, cut.shape)


@torch.no_grad()
def block_scores(tree, spec: dict, cuts: dict | None = None) -> dict:
    """``{path: block_abs_sum(stacked leaf)}`` for every controlled leaf of
    ``tree`` — applied to masked params it yields the controller's prune
    scores, to pre-mask grads its regrow scores (RigL's dense gradients).
    With ``cuts`` (``{path: Cut}``) ``tree`` holds a rank's slices and the
    scores are its global-shaped partials (:func:`shard_block_scores`)."""
    leaves = stacked_leaves(tree)
    return {path: _leaf_scores(leaves[path], spec[path], None if cuts is None else cuts[path])
            for path in spec if path in leaves}


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


def shard_block_mask(mask, block: tuple[int, int], offsets: tuple, shape: tuple):
    """A rank's slice of a global block mask ``[*lead, Kb, Nb]`` at element
    granularity: the ``[*shape]`` boolean mask of the slice of the global
    ``[*lead, Kb*bk, Nb*bn]`` tensor that starts at element ``offsets``.
    Local row ``i`` lies in block ``(offset + i) // bk``, so a slice that
    starts or ends inside a block takes the part of it the slice holds."""
    bk, bn = block
    *lead_at, k0, n0 = offsets
    *lead, k, n = shape
    m = mask[tuple(slice(o, o + s) for o, s in zip(lead_at, lead))]
    rows = torch.div(k0 + torch.arange(k, device=mask.device), bk, rounding_mode="floor")
    cols = torch.div(n0 + torch.arange(n, device=mask.device), bn, rounding_mode="floor")
    return m.index_select(-2, rows).index_select(-1, cols)


def _local_mask(mask, block, offsets: tuple, shape: tuple):
    """``(mask, granularity)`` of the slice ``[*shape]`` at ``offsets`` of a
    global ``[*lead, Kb*bk, Nb*bn]`` tensor: its blocks of the global mask
    where the slice starts and ends on block edges (the whole tensor among
    them), else its element mask (:func:`shard_block_mask`)."""
    bk, bn = block
    *lead_at, k0, n0 = offsets
    *lead, k, n = shape
    if (k0 % bk, k % bk, n0 % bn, n % bn) == (0, 0, 0, 0):
        at = tuple(slice(o, o + s) for o, s in zip(lead_at, lead))
        return mask[(*at, slice(k0 // bk, (k0 + k) // bk), slice(n0 // bn, (n0 + n) // bn))], block
    return shard_block_mask(mask, block, offsets, shape), (1, 1)


def local_masks(leaf: StackedLeaf, mask, block, cut: Cut | None = None):
    """``(x, m, granularity)`` for each tensor of a controlled leaf: ``x`` a
    ``[*, k, n]`` view of the tensor (a per-layer vector as one row) and
    ``m`` the mask of its ``granularity`` blocks that expands to ``x``'s
    element mask; under ``cut`` the tensors are a rank's slices."""
    offsets = (0,) * len(leaf.shape) if cut is None else cut.offsets
    if not leaf.stacked:
        x = leaf.leaves[0]
        yield (x, *_local_mask(mask, block, offsets, tuple(x.shape)))
    elif leaf.leaves[0].dim() >= 2:
        for x, m in zip(leaf.leaves, mask):
            yield (x, *_local_mask(m, block, offsets[1:], tuple(x.shape)))
    else:  # per-layer vectors: layer l is row l of the [L, d] matrix, in block row l // bk
        bk, bn = block
        for l, x in enumerate(leaf.leaves):
            row = x.view(1, -1)
            yield (row, *_local_mask(mask[l // bk][None], (1, bn), (0, offsets[1]), tuple(row.shape)))


@torch.no_grad()
def apply_block_masks(params, masks: dict, spec: dict, cuts: dict | None = None):
    """Zero the masked-off blocks of every controlled weight, in place, and
    return ``params``.

    ``masks`` maps keystr paths to ``[*lead, Kb, Nb]`` boolean block masks
    over the JAX package's stacked shape; ``spec`` maps the same paths to
    their ``(bk, bn)`` block geometry (``DynamicSparsityController.spec()``).
    Uncontrolled leaves are untouched.  Works on gradients too (pass them
    in the parameters' structure) — masking grads before the optimizer is
    what pins pruned weights (and their Adam moments' updates) at zero
    between refreshes.  With ``cuts`` (``{path: Cut}``) ``params`` holds a
    rank's slices, each masked by its slice of the global mask.
    """
    leaves = stacked_leaves(params)
    for path, mask in masks.items():
        for x, m, blk in local_masks(leaves[path], mask, spec[path], None if cuts is None else cuts[path]):
            _mask_matrix_(x, m, blk)
    return params
