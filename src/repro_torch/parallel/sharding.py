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
  sequence dim over ``data``.

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
"""
from __future__ import annotations

import dataclasses
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
    "constrain",
    "local_shard",
    "gather_shard",
    "axis_group",
    "axis_sizes",
    "all_gather_cat",
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
    seq_ax = "data" if not batch_sharded and shape.seq_len % sizes["data"] == 0 else None
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


def local_shard(x: torch.Tensor, spec: tuple, policy: "ShardingPolicy") -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec`` (a view): each dim named by
    mesh axes is cut into as many equal slices as the axes have ranks
    together.  The counterpart of the JAX package's ``param_shardings``
    placed by ``device_put``.  A dim that does not divide raises, as
    ``shard_map`` does; a policy without a mesh returns ``x``."""
    if policy.mesh is None:
        return x
    for dim, entry in enumerate(spec):
        _, n, i = axis_group(policy.mesh, _entry_axes(entry))
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide into {n} shards ({entry})")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


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
    tuple so the policy stays hashable).  The sharded SpMM executors
    (:mod:`repro_torch.parallel.spmm`) and ``Runtime.matmul_sharded`` read
    this one object.  ``mesh=None`` is the one-device policy: every helper
    degrades (no shards, every dim replicated)."""

    mesh: Any = None
    data_axes: tuple = DP
    model_axis: str = "model"
    rules: Any = None

    def __post_init__(self):
        if not isinstance(self.data_axes, tuple):
            object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if self.rules is not None and not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(sorted(dict(self.rules).items())))

    def replace(self, **kw) -> "ShardingPolicy":
        return dataclasses.replace(self, **kw)

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
