"""Dynamic sparse training (port of ``repro.sparse_train``): block-structured
RigL prune/regrow whose mask updates are incremental CSR plan edits, not
replans.

Public surface:

* :class:`DynamicSparsityController` / :class:`DynamicSparsityConfig` —
  the host-side mask owner (``repro_torch.sparse_train.controller``).
* :func:`edit_plan` / :class:`PlanDelta` / :func:`plan_from_block_mask` —
  the splice primitives (``repro_torch.sparse_train.plan_edit``).
* :func:`apply_block_masks` / :func:`block_abs_sum` /
  :func:`expand_block_mask` — mask utilities over the port's per-layer
  parameter trees, keyed by the JAX package's stacked paths
  (``repro_torch.sparse_train.masks``); on a mesh :func:`leaf_cuts` places a
  rank's shards in the global leaves, :func:`shard_block_mask` gives its
  slice of a global mask and :func:`shard_block_scores` its partial scores.

Wired end-to-end via ``repro_torch.train.step.make_train_step(
dynamic_sparsity=)`` and ``python -m repro_torch.launch.train
--dynamic-sparsity``.
"""
from repro_torch.sparse_train.controller import (
    DynamicSparsityConfig,
    DynamicSparsityController,
)
from repro_torch.sparse_train.masks import (
    Cut,
    apply_block_masks,
    block_abs_sum,
    block_scores,
    expand_block_mask,
    leaf_cuts,
    mask_density,
    mask_paths,
    maskable,
    shard_block_mask,
    shard_block_scores,
    stacked_leaves,
)
from repro_torch.sparse_train.plan_edit import (
    PlanDelta,
    apply_delta,
    edit_plan,
    plan_from_block_mask,
)

__all__ = [
    "DynamicSparsityConfig",
    "DynamicSparsityController",
    "PlanDelta",
    "apply_delta",
    "edit_plan",
    "plan_from_block_mask",
    "Cut",
    "apply_block_masks",
    "block_abs_sum",
    "block_scores",
    "expand_block_mask",
    "leaf_cuts",
    "mask_density",
    "mask_paths",
    "maskable",
    "shard_block_mask",
    "shard_block_scores",
    "stacked_leaves",
]
