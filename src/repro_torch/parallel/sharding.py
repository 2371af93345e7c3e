"""Logical-axis -> mesh-axis sharding rules and the process groups behind
them (port of ``repro/parallel/sharding.py``).

Parameters are declared with logical axes (``models/common.Spec.axes``);
this module maps them onto a mesh with named axes ``pod``, ``data`` and
``model``:

* ``model``: tensor parallel (attention heads, FFN hidden, vocab) and expert
  parallel (the MoE expert dim; the dispatch all-to-all lives in
  ``models/moe.py``);
* ``data`` (and ``pod``): batch data-parallel, and FSDP of the d_model dim
  of weight matrices and of the per-expert FFN dim;
* sequence parallelism: long-context (batch 1) decode shards the KV cache's
  sequence dim over ``data`` (:func:`seq_axis`; a policy's ``seq_axis``
  names it, and the decode attention combines the ranks' rows:
  :func:`repro_torch.models.attention.seq_combine`).

The spec helpers return one tuple per tensor, the mesh-axis name (a tuple
of names for several axes, or ``None``) of each dim, where the JAX package
returns a ``PartitionSpec``; a dim that does not divide its mesh axis is
replicated.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims, or, for the spec tables alone, any object with ``axis_names``
and a ``shape`` dict (sizes by name), as the JAX package's tests use.

There is no GSPMD here: a rank holds the slices :func:`local_shard` cuts,
and the collectives are explicit (``parallel/spmm.py``, ``models/moe.py``,
``optim/compress.py``).  Every shard index is the rank's position in the
process group of its axes, the order the collectives gather in.

Whole dense and MoE models shard on this (:class:`ModelShards`): a rank
holds the :func:`local_shard` of every parameter under
:meth:`ShardingPolicy.param_pspecs`, and the model bodies run local
products on local weights between explicit, differentiable collectives:

* :func:`fsdp_gather` gathers a weight's ``data``-sharded dim before use;
  its backward reduce-scatters (sums) the gradient over the same group;
* :func:`tp_copy` (identity, backward all-reduce over ``model``) where a
  replicated activation or weight enters a tensor-parallel region, and
  :func:`tp_reduce` (all-reduce, backward identity) where the region's
  partial sums leave it;
* :func:`tp_sum` (all-reduce, backward all-reduce) for a statistic each
  rank adds its part to and every rank then uses on its own part (the
  Mamba2 gated norm's sum of squares over the channels the ranks split);
* :func:`tp_split` / :func:`tp_gather` cut a replicated activation over
  ``model`` and put it back together (the MoE's sequence split, the served
  logits);
* :func:`vocab_parallel_ce`, the cross entropy of vocab-sharded logits:
  the max, the sum of exponentials and the target logit are all-reduced
  over ``model``, and the logits are never gathered.

Every helper skips its collective over a group of one rank and returns its
input as it is (a weight keeps its identity, so a plan keyed by it is found
again).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "ShardingPolicy",
    "LOGICAL_RULES",
    "data_axes",
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "logits_pspec",
    "rank_cache_pspecs",
    "seq_axis",
    "constrain",
    "local_shard",
    "gather_shard",
    "axis_group",
    "axis_sizes",
    "all_gather_cat",
    "shard_slice",
    "shard_bounds",
    "shard_extent",
    "rank_index",
    "BatchShape",
    "ModelShards",
    "spec_leaves",
    "map_specs",
    "shard_tree",
    "gather_tree",
    "gather_to_first",
    "fsdp_gather",
    "gather_model",
    "gather_dim",
    "tp_copy",
    "tp_reduce",
    "tp_split",
    "tp_gather",
    "tp_sum",
    "vocab_parallel_ce",
    "ce_local_max",
    "ce_local_sums",
    "ce_local_grad",
    "reduce_replicated_grads",
    "owner_mask",
    "mesh_all_reduce",
]


def constrain(x, mesh, spec: tuple):
    """The identity.  The JAX package pins activations with
    ``with_sharding_constraint`` so GSPMD does not leave them replicated;
    here nothing propagates shardings (each rank computes on the slices it
    holds), so there is nothing to pin."""
    del mesh, spec
    return x


DP = ("pod", "data")  # batch data-parallel axes (filtered by mesh presence)

#: logical axis -> preferred mesh axis (checked for divisibility per tensor)
LOGICAL_RULES: dict[str, str | None] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": "data",  # FSDP inside the expert-parallel MoE
    "expert_embed": None,
    "embed": "data",  # FSDP: gathered per layer
    "layers": None,
    "ssm_head": "model",
}


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, in mesh order, for a ``DeviceMesh`` or a
    duck-typed mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(_names(mesh), mesh.shape))


def data_axes(mesh) -> tuple:
    return tuple(a for a in DP if a in _names(mesh))


def _prod(sizes: dict, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _pspec_for(spec, mesh, rules=None) -> tuple:
    rules = LOGICAL_RULES if rules is None else rules
    axes = spec.axes if spec.axes is not None else (None,) * len(spec.shape)
    names, sizes = _names(mesh), axis_sizes(mesh)
    parts, used = [], set()
    for dim, ax in zip(spec.shape, axes):
        rule = rules.get(ax) if ax else None
        if rule is None or rule in used or rule not in names or dim % sizes[rule]:
            parts.append(None)  # no rule, axis taken or absent, or not divisible: replicate
            continue
        parts.append(rule)
        used.add(rule)
    return tuple(parts)


def param_pspecs(specs, mesh, rules=None):
    """The spec tuple of every leaf of a ``Spec`` tree.  ``rules`` overrides
    the logical-axis table (default :data:`LOGICAL_RULES`)."""
    return _tree_map(lambda s: _pspec_for(s, mesh, rules), specs)


def _entry(axes: tuple):
    """A spec entry for ``axes`` taken together: the one name, a tuple of
    several, or ``None`` (the normal form of a ``PartitionSpec`` entry)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _batch_axis(shape, mesh):
    dp = data_axes(mesh)
    return _entry(dp) if shape.global_batch % _prod(axis_sizes(mesh), dp) == 0 else None


def batch_pspecs(cfg, shape, mesh) -> dict:
    """Spec tuples of the input batch of one (config x input shape) cell;
    ``shape`` has ``global_batch``, ``seq_len`` and ``kind``."""
    b_ax = _batch_axis(shape, mesh)
    out: dict[str, Any] = {}
    if cfg.frontend == "vision":
        out["inputs_embeds"] = (b_ax, None, None)
        out["positions"] = (b_ax, None, None)
    elif cfg.frontend == "audio":
        out["inputs_embeds"] = (b_ax, None, None)
    else:
        out["tokens"] = (b_ax, None)
    if shape.kind == "train":
        out["labels"] = (b_ax, None) if cfg.frontend != "audio" else (b_ax, None, None)
    return out


def cache_pspecs(cfg, shape, mesh, cache_tree):
    """Spec tuples of a decode-cache tree (a leaf's batch dim is its first
    dim equal to ``global_batch``): batch over the data axes, the sequence
    dim over ``data`` for an unshardable (batch 1) long decode, and the
    first other dim after the batch that divides ``model`` over ``model``."""
    from repro_torch.runtime.runtime import tree_map  # local: runtime imports this module

    del cfg
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    batch_sharded = shape.global_batch % _prod(sizes, dp) == 0
    b_ax = _entry(dp) if batch_sharded else None
    seq_ax = seq_axis(shape, mesh)
    model_n = sizes["model"]

    def leaf_spec(x) -> tuple:
        shp = tuple(x.shape)
        parts: list = [None] * len(shp)
        bdim = next((i for i, d in enumerate(shp) if d == shape.global_batch), None)
        if bdim is None:
            return tuple(parts)
        parts[bdim] = b_ax
        seq_dim = next((i for i in range(bdim + 1, len(shp)) if shp[i] == shape.seq_len), None)
        if seq_dim is not None and seq_ax and shp[seq_dim] % sizes["data"] == 0:
            parts[seq_dim] = seq_ax
        for i in range(bdim + 1, len(shp)):
            if i != seq_dim and shp[i] % model_n == 0 and shp[i] > 1:
                parts[i] = "model"
                break
        return tuple(parts)

    return tree_map(leaf_spec, cache_tree)


def seq_axis(shape, mesh) -> str | None:
    """The axis a decode cache's sequence dim splits over for one cell
    (``shape``: ``global_batch``, ``seq_len``): ``"data"`` where the batch
    does not divide the data axes (batch-1 long decode) and the sequence
    divides ``data``, else ``None``.  A ``pod`` axis replicates the split,
    as in the JAX package."""
    sizes = axis_sizes(mesh)
    if shape.global_batch % _prod(sizes, data_axes(mesh)) == 0:
        return None
    return "data" if shape.seq_len % sizes["data"] == 0 else None


#: a decode-cache field that holds one row per sequence position at dim 1
#: (the port's cache named tuples, batch first): a KV cache's K/V and
#: scales, an MLA cache's latent and RoPE key
CACHE_SEQ_FIELDS = frozenset({"k", "v", "k_scale", "v_scale", "c_kv", "k_pe"})

#: a decode-cache field (the port's cache named tuples, batch first) that a
#: tensor-parallel model rank holds only its part of: ``(what splits it, its
#: dim)``: a KV cache's kv heads, a Mamba2 layer's ``conv_x`` channels and
#: state heads.  Every other field (an MLA latent, ``conv_b``/``conv_c``) is
#: held whole
CACHE_MODEL_DIMS = {"k": ("kv", 2), "v": ("kv", 2), "k_scale": ("kv", 2), "v_scale": ("kv", 2),
                    "conv_x": ("ssm", 2), "state": ("ssm", 1)}


def rank_cache_pspecs(cache_tree, data_axes: tuple, splits, model: str = "model", seq: str | None = None):
    """Spec tuples of a sharded model's decode caches from their layouts:
    the batch dim (0) over ``data_axes`` (none: the slots whole), over
    ``model`` the dim :data:`CACHE_MODEL_DIMS` names for a field whose kind
    is in ``splits`` (``"kv"``, ``"ssm"``: what the model runs
    tensor-parallel; ``models.model.cache_splits``), and with ``seq`` (an
    axis, :func:`seq_axis`) the sequence dim of each
    :data:`CACHE_SEQ_FIELDS` field over it.  JAX's :func:`cache_pspecs`
    matches dims by size instead, and would cut an MLA latent or a conv
    tail that happens to divide the model axis; here the caches hold what
    the local steps compute."""
    data = _entry(tuple(data_axes))

    def leaf(x, field):
        parts = [None] * x.ndim
        parts[0] = data
        if seq is not None and field in CACHE_SEQ_FIELDS:
            parts[1] = seq
        kind, dim = CACHE_MODEL_DIMS.get(field, (None, None))
        if kind in splits:
            parts[dim] = model
        return tuple(parts)

    def walk(tree, field=None):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v, f) for f, v in zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return None if tree is None else leaf(tree, field)

    return walk(cache_tree)


def logits_pspec(cfg, shape, mesh) -> tuple:
    b_ax = _batch_axis(shape, mesh)
    v_ax = "model" if cfg.vocab_size % axis_sizes(mesh)["model"] == 0 else None
    if cfg.frontend == "audio":
        return (b_ax, None, None, v_ax)
    return (b_ax, None, v_ax)


# ---------------------------------------------------------------------------
# process groups and the slices a rank holds
# ---------------------------------------------------------------------------

#: flattened groups of several mesh axes, per (mesh, axes): made once, by
#: every rank in the same order (a group is made collectively)
_FLAT: dict = {}


def axis_group(mesh, axes: tuple):
    """``(group, size, index)`` of this rank over mesh ``axes`` taken
    together: the process group (``None`` for no axes), its size and this
    rank's position in it.  One axis is the mesh's own group; several are
    one flattened group per coordinate of the other axes, made on first use
    (every rank must ask for it, as every rank makes a collective)."""
    axes = tuple(axes)
    if not axes:
        return None, 1, 0
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        key = (id(mesh), axes)
        if key not in _FLAT:
            names = _names(mesh)
            ranks = mesh.mesh
            dims = [names.index(a) for a in axes]
            rest = [i for i in range(ranks.ndim) if i not in dims]
            rows = ranks.permute(*rest, *dims).reshape(-1, _prod(axis_sizes(mesh), axes)).tolist()
            _FLAT[key] = (mesh, dist.new_subgroups_by_enumeration(rows)[0])
        group = _FLAT[key][1]
    return group, dist.get_world_size(group), dist.get_rank(group)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_bounds(shape: tuple, spec: tuple, index_of) -> tuple[tuple, tuple]:
    """``(shape, offsets)`` of the slice of a tensor of ``shape`` that
    :func:`shard_slice` cuts under ``spec``: its shape and the element
    offset on each dim (the inverse of :func:`shard_extent`).  Needs no
    process group; a dim that does not divide raises."""
    sizes, offsets = list(shape), [0] * len(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = index_of(entry)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {n} shards ({entry})")
        sizes[dim] = shape[dim] // n
        offsets[dim] = i * sizes[dim]
    return tuple(sizes), tuple(offsets)


def shard_slice(x: torch.Tensor, spec: tuple, index_of) -> torch.Tensor:
    """The slice of ``x`` (a view) that ``spec`` gives the shard whose
    ``(count, index)`` for each spec entry is ``index_of(entry)``: each dim
    named by mesh axes is cut into ``count`` equal slices.  Needs no process
    group, so one card can cut every rank's slice in turn; a dim that does
    not divide raises, as ``shard_map`` does."""
    sizes, offsets = shard_bounds(tuple(x.shape), spec, index_of)
    for dim, (n, start) in enumerate(zip(sizes, offsets)):
        if n != x.shape[dim]:
            x = x.narrow(dim, start, n)
    return x


def shard_extent(shape: tuple, spec: tuple, index_of) -> tuple[tuple, tuple]:
    """``(global shape, offsets)`` of a shard of ``shape`` cut under
    ``spec``: the shape of the tensor :func:`shard_slice` cut it from, and
    the element offset of the shard on each dim, for the shard whose
    ``(count, index)`` for each spec entry is ``index_of(entry)``.  Needs no
    process group."""
    full, offsets = [], []
    for n, entry in zip(shape, spec):
        count, i = (1, 0) if entry is None else index_of(entry)
        full.append(n * count)
        offsets.append(n * i)
    return tuple(full), tuple(offsets)


def rank_index(policy: "ShardingPolicy"):
    """``index_of`` of this rank under ``policy``'s mesh: a spec entry ->
    ``(count, index)`` of the rank over the entry's axes (the argument
    :func:`shard_slice` and :func:`shard_extent` take)."""
    return lambda e: axis_group(policy.mesh, _entry_axes(e))[1:]


def local_shard(x: torch.Tensor, spec: tuple, policy: "ShardingPolicy") -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec`` (a view): each dim named by
    mesh axes is cut into as many equal slices as the axes have ranks
    together.  The counterpart of the JAX package's ``param_shardings``
    placed by ``device_put``.  A dim that does not divide raises, as
    ``shard_map`` does; a policy without a mesh returns ``x``."""
    if policy.mesh is None:
        return x
    return shard_slice(x, spec, rank_index(policy))


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in group
    order (``x`` itself for no group)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_shard(x: torch.Tensor, spec: tuple, policy: "ShardingPolicy") -> torch.Tensor:
    """The global tensor from this rank's slice under ``spec``: the inverse
    of :func:`local_shard`, one all-gather per sharded dim."""
    if policy.mesh is None:
        return x
    for dim, entry in enumerate(spec):
        group, n, _ = axis_group(policy.mesh, _entry_axes(entry))
        if n > 1:
            x = all_gather_cat(x, group, dim)
    return x


# ---------------------------------------------------------------------------
# the declarative policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Mesh + axis roles + the spec tables, one value.

    ``data_axes`` names the row-parallel (M / batch) axes in mesh order,
    ``model_axis`` the tensor-parallel one (N / K), ``rules`` the
    logical-axis table (default :data:`LOGICAL_RULES`, kept as a sorted
    tuple so the policy stays hashable), ``seq_axis`` the axis the decode
    caches' sequence dim is split over (:func:`seq_axis`; ``None``: each
    rank holds its slots' whole rows).  The sharded SpMM executors
    (:mod:`repro_torch.parallel.spmm`) and ``Runtime.matmul_sharded`` read
    this one object.  ``mesh=None`` is the one-device policy: every helper
    degrades (no shards, every dim replicated)."""

    mesh: Any = None
    data_axes: tuple = DP
    model_axis: str = "model"
    rules: Any = None
    seq_axis: str | None = None

    def __post_init__(self):
        if not isinstance(self.data_axes, tuple):
            object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if self.rules is not None and not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(sorted(dict(self.rules).items())))

    def replace(self, **kw) -> "ShardingPolicy":
        return dataclasses.replace(self, **kw)

    @property
    def size(self) -> int:
        """The mesh's rank count (1 without a mesh)."""
        return 1 if self.mesh is None else math.prod(axis_sizes(self.mesh).values())

    @property
    def rule_table(self) -> dict:
        return dict(self.rules) if self.rules is not None else dict(LOGICAL_RULES)

    def spmm_axes(self, axis: str) -> tuple[tuple, int, Any]:
        """``(mesh axes, shard count, process group)`` behind one SpMM shard
        axis: ``"M"`` over the policy's data axes present in the mesh
        (several: their flattened group), ``"N"``/``"K"`` over the model
        axis.  Absent axes drop out, so the count degrades to 1 (run
        unsharded, no group)."""
        if axis not in ("M", "N", "K"):
            raise ValueError(f"shard axis {axis!r} not in ('M', 'N', 'K')")
        if self.mesh is None:
            return (), 1, None
        names = self.data_axes if axis == "M" else (self.model_axis,)
        present = tuple(a for a in names if a in _names(self.mesh))
        size = _prod(axis_sizes(self.mesh), present)
        if size == 1:
            return present, 1, None
        return present, size, axis_group(self.mesh, present)[0]

    def param_pspecs(self, specs):
        if self.mesh is None:
            return _tree_map(lambda s: (None,) * len(s.shape), specs)
        return param_pspecs(specs, self.mesh, self.rule_table)

    def batch_pspecs(self, cfg, shape):
        if self.mesh is None:
            return {k: (None,) * len(v) for k, v in batch_pspecs(cfg, shape, _ONE).items()}
        return batch_pspecs(cfg, shape, self.mesh)

    def cache_pspecs(self, cfg, shape, cache_tree):
        from repro_torch.runtime.runtime import tree_map  # local: runtime imports this module

        if self.mesh is None:
            return tree_map(lambda x: (None,) * x.ndim, cache_tree)
        return cache_pspecs(cfg, shape, self.mesh, cache_tree)

    def logits_pspec(self, cfg, shape):
        if self.mesh is None:
            return (None,) * len(logits_pspec(cfg, shape, _ONE))
        return logits_pspec(cfg, shape, self.mesh)

    def constrain(self, x, spec: tuple):
        return constrain(x, self.mesh, spec)


@dataclasses.dataclass(frozen=True)
class _OneDevice:
    """A one-device duck-typed mesh, for the shapes of the mesh-less specs."""

    axis_names: tuple = ("data", "model")
    shape: dict = dataclasses.field(default_factory=lambda: {"data": 1, "model": 1})


_ONE = _OneDevice()


# ---------------------------------------------------------------------------
# the sharded model: its groups and its differentiable collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchShape:
    """One input cell for :func:`batch_pspecs` / :func:`cache_pspecs`: the
    global batch, the sequence length and ``kind`` (``"train"`` adds the
    labels)."""

    global_batch: int
    seq_len: int
    kind: str = "train"


class ModelShards:
    """The groups a sharded model body runs over, from a mesh-backed
    ``policy``, and ``specs``, the spec tuples of the model's parameters
    (``policy.param_pspecs(param_specs(cfg))``).

    ``data_group`` spans the policy's data axes present in the mesh (the
    batch's), ``model_group`` the model axis; each is ``None`` over one
    rank, with ``n_data``/``tp`` its size and ``data_rank``/``tp_rank``
    this rank's position.  Under a policy's ``seq_axis`` the decode
    caches' sequence dim is split over that axis: ``seq_group`` (``None``
    over one rank), ``n_seq`` and ``seq_rank``; :meth:`seq_offset` is the
    first global row of this rank's rows.  Every rank of the mesh must
    build it (a group over several axes is made collectively on first
    use)."""

    def __init__(self, policy: "ShardingPolicy", specs):
        if policy.mesh is None:
            raise ValueError("ModelShards needs a mesh-backed policy")
        self.policy, self.specs = policy, specs
        self.data_axes, self.n_data, self.data_group = policy.spmm_axes("M")
        self.model_axes, self.tp, self.model_group = policy.spmm_axes("N")
        self.data_rank = dist.get_rank(self.data_group) if self.data_group is not None else 0
        self.tp_rank = dist.get_rank(self.model_group) if self.model_group is not None else 0
        self.world = policy.size
        self.seq_group, self.n_seq, self.seq_rank = None, 1, 0
        if policy.seq_axis is not None:
            group, self.n_seq, self.seq_rank = axis_group(policy.mesh, (policy.seq_axis,))
            self.seq_group = group if self.n_seq > 1 else None

    def seq_offset(self, rows: int) -> int:
        """The first global sequence row of this rank's ``rows`` cache rows."""
        return self.seq_rank * rows

    def group_of(self, entry) -> tuple:
        """``(group, size, index)`` of a spec entry (see :func:`axis_group`)."""
        return axis_group(self.policy.mesh, _entry_axes(entry))

    def is_data(self, entry) -> bool:
        axes = _entry_axes(entry)
        return bool(axes) and all(a in self.policy.data_axes for a in axes)

    def is_model(self, entry) -> bool:
        return _entry_axes(entry) == (self.policy.model_axis,)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (nested dicts, lists and named
    tuples) and its spec tree, whose leaves are spec tuples (``None`` for a
    leaf that is no tensor, as an optimizer's step)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, sp) for v, sp in zip(tree, specs)))
    if isinstance(tree, list):
        return [map_specs(fn, v, sp) for v, sp in zip(tree, specs)]
    return tree if specs is None else fn(tree, specs)


def shard_tree(tree, specs, policy: "ShardingPolicy"):
    """This rank's shards of a tree of global tensors under a spec tree
    (each a contiguous copy, so the global tensors can be freed)."""
    return map_specs(lambda x, sp: local_shard(x, sp, policy).contiguous().clone(), tree, specs)


def gather_tree(tree, specs, policy: "ShardingPolicy"):
    """The global tensors of a tree of this rank's shards (every rank gets
    them all; :func:`gather_shard` per leaf)."""
    return map_specs(lambda x, sp: gather_shard(x, sp, policy), tree, specs)


def gather_to_first(x: torch.Tensor, spec: tuple, policy: "ShardingPolicy"):
    """The global tensor of the ranks' slices of ``x`` under ``spec``, on
    the host of the mesh's first rank, ``None`` on every other rank: each
    distinct slice is sent once, by the first rank holding it, so no device
    holds more than its own slice (a checkpoint's gather, leaf by leaf).
    Slices are placed by the ranks' mesh coordinates, row-major over a
    spec entry's axes, as :func:`local_shard` cuts them.  Every rank of the
    mesh must call it."""
    import itertools

    mesh = policy.mesh
    names, sizes, ranks = _names(mesh), axis_sizes(mesh), mesh.mesh
    me, first = dist.get_rank(), int(ranks.reshape(-1)[0])
    sharded = _leaf_axes(spec)
    shape = list(x.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= _prod(sizes, _entry_axes(entry))
    full = torch.empty(shape, dtype=x.dtype) if me == first else None

    def index_of(coord):
        def at(entry):
            axes = _entry_axes(entry)
            i = 0
            for a in axes:
                i = i * sizes[a] + coord[names.index(a)]
            return _prod(sizes, axes), i
        return at

    for coord in itertools.product(*(range(sizes[a]) if a in sharded else (0,) for a in names)):
        src = int(ranks[coord])
        if me == src and src != first:
            dist.send(x.contiguous(), dst=first)
        elif me == first:
            piece = x
            if src != first:
                piece = torch.empty_like(x)
                dist.recv(piece, src=src)
            shard_slice(full, spec, index_of(coord)).copy_(piece)
    return full


def spec_leaves(specs) -> list:
    """The spec tuples of a spec tree (nested dicts, keys sorted, and
    lists), in the order ``optim.adamw.tree_leaves`` walks the parameters."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group``, summed in fp32 for a
    lower-precision float (cast back)."""
    out = x.float().clone() if x.is_floating_point() and x.element_size() < 4 else x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, cut along ``dim`` into as many
    slices as the group has ranks; this rank's slice (fp32 sums for a
    lower-precision float)."""
    n = dist.get_world_size(group)
    x32 = x.float() if x.element_size() < 4 else x
    parts = [p.contiguous() for p in x32.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.dtype)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters the gradient
    (``grad_sum``: every rank used the whole tensor on other data) or takes
    this rank's slice of it (every rank computed the same thing)."""

    @staticmethod
    def forward(ctx, x, dim, group, grad_sum):
        ctx.dim, ctx.group, ctx.grad_sum = dim, group, grad_sum
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        run = _reduce_scatter if ctx.grad_sum else _own_slice
        return run(g, ctx.dim, ctx.group), None, None, None


class _Copy(torch.autograd.Function):
    """The identity; the backward all-reduces (sums) the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """An all-reduce (sum); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    """An all-reduce (sum) whose backward all-reduces too: each rank's use
    of the sum reaches only its own part of what depends on it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a tensor-parallel region (each rank of ``group``
    computes a different part from it): the identity, whose backward sums
    the ranks' gradients."""
    return x if _size(group) == 1 else _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partials; the backward hands
    each rank the whole gradient."""
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def tp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' parts of a statistic that every
    rank then uses on the part of the computation it holds; the backward
    sums the ranks' gradients of it (each holds only its own share)."""
    return x if _size(group) == 1 else _Sum.apply(x, group)


def tp_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, which every rank of
    ``group`` holds whole; the backward all-gathers."""
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` along ``dim`` (the inverse of
    :func:`tp_split`); the backward takes this rank's slice."""
    return gather_dim(x, dim, group, grad_sum=False)


def gather_dim(x: torch.Tensor, dim: int, group, *, grad_sum: bool) -> torch.Tensor:
    """``x`` of every rank of ``group`` along ``dim``; the backward
    reduce-scatters the gradient with ``grad_sum`` (each rank used the
    whole on its own data) and takes this rank's slice without (each rank
    computed the same thing)."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group, grad_sum)


def _gather_dims(w: torch.Tensor, spec: tuple, shards: ModelShards, want, grad_sum: bool) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if entry is not None and want(entry):
            w = gather_dim(w, dim, shards.group_of(entry)[0], grad_sum=grad_sum)
    return w


def fsdp_gather(w: torch.Tensor, spec: tuple, shards: ModelShards) -> torch.Tensor:
    """``w`` gathered over the data axes its ``spec`` shards it on (FSDP),
    still sliced over ``model``.  The backward reduce-scatters the
    gradient: every data rank used the whole weight on its own rows, so the
    slice's gradient is their sum."""
    return _gather_dims(w, spec, shards, shards.is_data, True)


def gather_model(w: torch.Tensor, spec: tuple, shards: ModelShards, *, grad_sum: bool = False) -> torch.Tensor:
    """``w`` gathered over the model axis where its ``spec`` shards it: for
    a body that runs replicated over ``model`` (its backward takes this
    rank's slice) or, with ``grad_sum``, one whose ranks each use a
    different part of the whole (its backward reduce-scatters)."""
    return _gather_dims(w, spec, shards, shards.is_model, grad_sum)


def ce_local_max(logits: torch.Tensor) -> torch.Tensor:
    """The rows' max over this shard's vocab slice: ``[N, V/tp] -> [N]``."""
    return logits.max(dim=-1).values


def ce_local_sums(logits: torch.Tensor, labels: torch.Tensor, start: int, gmax: torch.Tensor):
    """This shard's ``(sum of exp(logit - gmax), target logit - gmax)`` per
    row, the target's term 0 where the label is outside the slice
    ``[start, start + V/tp)``."""
    z = logits - gmax[:, None]
    local = labels.long() - start
    inside = (local >= 0) & (local < logits.shape[-1])
    tgt = torch.gather(z, -1, local.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    return torch.exp(z).sum(dim=-1), torch.where(inside, tgt, torch.zeros_like(tgt))


def ce_local_grad(logits, labels, start: int, gmax, gsum, g) -> torch.Tensor:
    """The gradient of the rows' NLL on this shard's logits: ``(softmax -
    onehot) * g``, the softmax from the global max and sum."""
    p = torch.exp(logits - gmax[:, None]) / gsum[:, None]
    local = labels.long() - start
    inside = (local >= 0) & (local < logits.shape[-1])
    onehot = torch.zeros_like(p).scatter_(1, local.clamp(0, p.shape[-1] - 1)[:, None], inside[:, None].to(p.dtype))
    return (p - onehot) * g[:, None]


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, start, group):
        gmax = ce_local_max(logits)
        if _size(group) > 1:
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        sums = torch.stack(ce_local_sums(logits, labels, start, gmax))
        if _size(group) > 1:
            dist.all_reduce(sums, group=group)
        gsum, tgt = sums[0], sums[1]
        ctx.start = start
        ctx.save_for_backward(logits, labels, gmax, gsum)
        return torch.log(gsum) - tgt

    @staticmethod
    def backward(ctx, g):
        logits, labels, gmax, gsum = ctx.saved_tensors
        return ce_local_grad(logits, labels, ctx.start, gmax, gsum, g), None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, start: int, group) -> torch.Tensor:
    """Per-row NLL ``[N]`` of fp32 logits ``[N, V/tp]`` sliced over the
    vocab from ``start`` on each rank of ``group`` (the model axis): the
    max, the sum of exponentials and the target logit each all-reduced, the
    logits never gathered; the same on every rank.  ``group=None`` is the
    unsharded cross entropy."""
    return _VocabParallelCE.apply(logits, labels, start, group)


def _leaf_axes(spec) -> set:
    return {a for e in spec for a in _entry_axes(e)}


def reduce_replicated_grads(grads: list, specs: list, shards: ModelShards) -> list:
    """Sum, over each data axis a leaf's spec does not shard it on, the
    gradients of the leaves (the FSDP-sharded ones were reduce-scattered in
    the backward).  ``grads`` and ``specs`` are parallel lists; returns the
    list, reduced."""
    out = []
    for g, spec in zip(grads, specs):
        axes = tuple(a for a in shards.data_axes if a not in _leaf_axes(spec))
        group, n, _ = axis_group(shards.policy.mesh, axes)
        out.append(_all_reduce(g, group) if n > 1 else g)
    return out


def owner_mask(specs: list, shards: ModelShards) -> list:
    """Per leaf, whether this rank counts it in a global sum: its
    coordinate is 0 on every mesh axis the leaf's spec does not shard it on
    (the first of the ranks holding the same slice), so a replicated leaf is
    counted once."""
    names = _names(shards.policy.mesh)
    coord = dict(zip(names, shards.policy.mesh.get_coordinate()))
    return [all(coord[a] == 0 for a in names if a not in _leaf_axes(spec)) for spec in specs]


def mesh_all_reduce(x: torch.Tensor, shards, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced (summed by default) over every rank of the mesh of
    ``shards`` (a :class:`ModelShards` or a :class:`ShardingPolicy`)."""
    mesh = getattr(shards, "policy", shards).mesh
    group, n, _ = axis_group(mesh, _names(mesh))
    return _all_reduce(x, group, op) if n > 1 else x
