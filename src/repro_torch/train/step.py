"""Train-step factory (port of ``repro/train/step.py``): microbatch
gradient accumulation, AdamW, metrics, the TensorDash sparsity taps and a
guard that skips a non-finite step.

The step runs eagerly under the ambient :class:`repro_torch.runtime.Runtime`
(``with rt.use():``).  Each microbatch's loss is differentiated with
``torch.autograd.grad``, so every planned product of the model (the fused
FFN gate, ``w_down``, the LM head) runs its backward through
:mod:`repro_torch.runtime.autodiff`: both gradient products (paper Eq. 2-3)
planned and executed by the runtime's backend.  Microbatches run in a Python
loop (``lax.scan`` in the JAX package) and their gradients are summed in
fp32 accumulators.  The optimizer updates parameters in place
(:mod:`repro_torch.optim.adamw`), so the parameter tensors a step is given
are the ones it updates and returns.

``sparsity_taps=True`` adds per-layer ``A_density`` (the FFN activation's
nonzero fraction) and ``G_density`` (the nonzero fraction of the gradient
at each layer's MLP output, through zero probes) and a ``modeled_speedup``
bound; :func:`modeled_speedup` refines the densities through
:mod:`repro_torch.core.perf_model` on the host (paper Fig. 14).

Under a runtime with a mesh (``Runtime(sharding=ShardingPolicy(mesh=...))``)
the step is sharded, for every family: ``params`` and the optimizer state
hold this rank's shards (``local_shard`` under the policy's
``param_pspecs``), each microbatch of the global batch (a frontend's
``inputs_embeds``, ``positions`` and labels too) is cut by
``batch_pspecs``, the loss is the global mean, the gradients of the leaves
replicated over a data axis are summed over it (the FSDP-sharded ones were
reduce-scattered in the backward, and the shares of a leaf every model
rank holds whole, as MLA's ``wq_a`` or Mamba2's ``in_b``, were summed over
``model`` by ``tp_copy`` in the backward), the gradient norm
is global with each replicated slice counted once, and AdamW updates the
local shards; every rank takes the same non-finite decision.

Dynamic sparse training runs on a mesh too.  The masks, their block
geometry and the scores stay the JAX package's global ones, the same on
every rank; each rank masks its own slices with its slice of each mask
(``sparse_train.masks.leaf_cuts``: a slice may start or end inside a mask
block), scores them into global-shaped partial block sums, and one
all-reduce over the mesh sums every leaf's partials (weights and gradients
in one flat buffer), each leaf counted once: a rank adds its partials only
where it is the first of the ranks holding the same slice
(``sharding.owner_mask``).

``dynamic_sparsity=`` (a :class:`repro_torch.sparse_train.
DynamicSparsityController` or its ``spec()``) runs RigL dynamic sparse
training: the step masks the parameters in place, emits the block scores
the controller prunes and regrows on, and masks the gradients and the
updated parameters, so a masked-off block stays exactly zero.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch import runtime as rtm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as S
from repro_torch.optim.adamw import (
    OptConfig,
    OptState,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_at,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.sparse_train.masks import (
    apply_block_masks, block_scores, leaf_cuts, local_masks, mask_density, stacked_leaves,
)

__all__ = ["make_train_step", "make_loss_fn", "init_train_state", "modeled_speedup", "accumulate_grads",
           "local_batch", "state_specs"]


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(params, batch, probes=None, taps=None)`` over ``cfg``."""
    def loss_fn(params, batch, probes=None, taps=None):
        return M.loss_fn(params, cfg, batch, probes=probes, taps=taps)

    return loss_fn


def init_train_state(cfg: ModelConfig, params):
    del cfg
    return init_opt_state(params)


def state_specs(cfg: ModelConfig, policy) -> dict:
    """The spec tuples of a train state ``{"params": ..., "opt": OptState}``
    under ``policy``: the moments shard as their parameters, the step is a
    host scalar (``None``).  What ``checkpoint.manager.save``/``restore``
    take as ``shardings``."""
    specs = policy.param_pspecs(M.param_specs(cfg))
    return {"params": specs, "opt": OptState(step=None, m=specs, v=specs)}


def _tap_stacks(cfg: ModelConfig) -> dict[str, int]:
    """The probed layer stacks of ``cfg`` (name -> layers) in the order the
    forward runs them: a MoE config's dense blocks ahead of its MoE blocks."""
    if cfg.family == "moe":
        stacks = {"dense_layers": cfg.first_dense_layers} if cfg.first_dense_layers else {}
        return stacks | {"layers": cfg.num_layers - cfg.first_dense_layers}
    return {"layers": cfg.num_layers}


def _tap_metrics(cfg: ModelConfig, taps: dict, gprobes: dict, sh=None) -> dict:
    """Per-layer A/G densities over every stack, concatenated in the order
    of :func:`_tap_stacks`, and the ideal work-skipping bound: each of the
    three training products does the same MACs and TensorDash at best prices
    FWD at ``dA``, BWD_INPUT at ``dG`` and BWD_WEIGHT at ``min(dA, dG)``
    (paper Eq. 1-3)."""
    a_parts, g_parts = [], []
    for stack in _tap_stacks(cfg):
        act, g = taps[stack]["ffn_act"], gprobes[stack]
        a_parts.append(1.0 - act.zeros / torch.clamp_min(act.total, 1.0))
        g_parts.append(torch.mean((g != 0).float(), dim=tuple(range(1, g.ndim))))
    a_density, g_density = torch.cat(a_parts), torch.cat(g_parts)
    if sh is not None:  # the mean over the data ranks' rows (the model ranks' probes are equal)
        g_density = S.mesh_all_reduce(g_density, sh) / sh.world
    ideal = 3.0 / (a_density + g_density + torch.minimum(a_density, g_density))
    return {"A_density": a_density, "G_density": g_density, "modeled_speedup": torch.mean(ideal)}


def _grads_of(loss_fn, cfg: ModelConfig, params, leaves, batch, sparsity_taps: bool, sh=None):
    """``(loss, grads in the leaves' order, tap metrics)`` of one batch;
    with taps, one zero probe ``[n_stack, B, S, D]`` per layer stack."""
    if not sparsity_taps:
        loss = loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves)), {}
    b, s = batch["tokens"].shape
    probes = {stack: torch.zeros((n, b, s, cfg.d_model), dtype=torch.float32,
                                 device=batch["tokens"].device, requires_grad=True)
              for stack, n in _tap_stacks(cfg).items()}
    taps: dict = {}
    loss = loss_fn(params, batch, probes=probes, taps=taps)
    grads = torch.autograd.grad(loss, leaves + list(probes.values()))
    gprobes = dict(zip(probes, grads[len(leaves):]))
    return loss.detach(), list(grads[:len(leaves)]), _tap_metrics(cfg, taps, gprobes, sh)


def local_batch(cfg: ModelConfig, batch: dict, sh) -> dict:
    """This rank's cut of the global ``batch`` under ``batch_pspecs`` (the
    batch itself without a mesh)."""
    if sh is None:
        return batch
    b, s = next(iter(batch.values())).shape[:2]
    specs = sh.policy.batch_pspecs(cfg, S.BatchShape(global_batch=b, seq_len=s, kind="train"))
    return {k: S.local_shard(v, specs[k], sh.policy) if k in specs else v for k, v in batch.items()}


def accumulate_grads(loss_fn, cfg: ModelConfig, params, batch, *, microbatches: int = 1,
                     sparsity_taps: bool = False, shards=None):
    """Loss and gradients of the global ``batch``, split on its leading
    axis into ``microbatches`` whose gradients are summed in fp32 and
    averaged.  Returns ``(loss, grads, tap metrics)``, ``grads`` in the
    order of ``tree_leaves(params)`` (in the parameters' dtype for one
    microbatch, fp32 for several).  Marks every parameter as requiring grad,
    in place: the tensors stay the same objects.

    On a mesh (``shards``, a :class:`~repro_torch.parallel.sharding.
    ModelShards`) ``params`` are this rank's shards and each microbatch of
    the global ``batch`` is cut by ``batch_pspecs`` (replicated over the
    data axes where its rows do not divide them, as the JAX package's
    microbatches are); the gradients come back complete for those shards:
    summed over the data axes each leaf is replicated on."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, grads, taps = _accumulate(loss_fn, cfg, params, leaves, batch, microbatches, sparsity_taps, shards)
    if shards is not None:
        grads = S.reduce_replicated_grads(grads, S.spec_leaves(shards.specs), shards)
    return loss, grads, taps


def _accumulate(loss_fn, cfg, params, leaves, batch, microbatches: int, sparsity_taps: bool, sh):
    if microbatches == 1:
        return _grads_of(loss_fn, cfg, params, leaves, local_batch(cfg, batch, sh), sparsity_taps, sh)
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"global batch {rows} is not divisible by {microbatches} microbatches")
    per = rows // microbatches
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    taps: dict = {}
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        l, g, t = _grads_of(loss_fn, cfg, params, leaves, local_batch(cfg, mb, sh), sparsity_taps, sh)
        for a, x in zip(acc, g):
            a.add_(x.float())
        del g
        loss = loss + l
        for k, x in t.items():
            taps[k] = taps.get(k, torch.zeros_like(x)) + x / microbatches
    for a in acc:
        a.div_(microbatches)
    return loss / microbatches, acc, taps


def modeled_speedup(metrics, cfg: ModelConfig, **kw) -> dict[str, float]:
    """One step's tapped densities through ``core.perf_model``: the
    per-layer A/G densities mapped onto the FFN contraction layers and run
    through the tile simulator on the metrics' device (the card's metrics
    on the card).  ``kw`` goes to ``perf_model.speedup_from_densities``."""
    from repro_torch.core import perf_model as pm

    kw.setdefault("device", metrics["A_density"].device)
    a = metrics["A_density"].detach().cpu().numpy()
    g = metrics["G_density"].detach().cpu().numpy()
    layers = pm.ffn_layers_from_config(cfg, n_layers=len(a))
    return pm.speedup_from_densities(a, g, layers, **kw)


@torch.no_grad()
def _held_blocks(params, masks: dict, spec: dict, cuts: dict | None = None) -> list:
    """What :func:`apply_block_masks` is about to zero that is not zero yet,
    as ``(blocks view, block mask, values)`` per tensor: the blocks a
    refresh has just pruned (between refreshes every masked-off block is
    already zero, and the list is empty).  Under ``cuts`` the tensors are a
    rank's slices, at the granularity of their slice of each mask.  One host
    sync."""
    leaves = stacked_leaves(params)
    views = []
    for path, mask in masks.items():
        for x, m, (bk, bn) in local_masks(leaves[path], mask, spec[path], None if cuts is None else cuts[path]):
            *lead, k, n = x.shape
            blocks = x.view(*lead, k // bk, bk, n // bn, bn).movedim(-3, -2)
            off = ~m.to(x.device).reshape(blocks.shape[:-2])
            views.append((blocks, off & (blocks != 0).flatten(-2).any(-1)))
    if not views:
        return []
    hit = torch.stack([off.any() for _, off in views]).tolist()  # lint: allow-host-sync: the one sync
    return [(blocks, off, blocks[off]) for (blocks, off), h in zip(views, hit) if h]


@torch.no_grad()
def _restore_blocks(held: list) -> None:
    for blocks, off, values in held:
        blocks[off] = values


def _stamp(params, masks: dict) -> list:
    """Each mask and controlled tensor with its ``_version``: equal stamps
    mean nothing wrote to them in between."""
    leaves = stacked_leaves(params)
    return [(t, t._version) for path, m in masks.items() for t in (m, *leaves[path].leaves)]


def _unchanged(stamp: list, now: list) -> bool:
    return len(stamp) == len(now) and all(a is b and v == w for (a, v), (b, w) in zip(stamp, now))


def _mesh_scores(trees: list, owner: dict, sh) -> list:
    """The global score trees from the ranks' partial ones: one all-reduce
    (sum) over the mesh of every tree's leaves in one flat fp32 buffer, a
    rank adding a leaf's partials only where ``owner[path]`` (the first of
    the ranks holding the same slice), so a replicated slice counts once."""
    if sh.world == 1:
        return trees
    flat = torch.cat([(x if owner[p] else torch.zeros_like(x)).reshape(-1) for t in trees for p, x in t.items()])
    flat = S.mesh_all_reduce(flat, sh)
    out, at = [], 0
    for t in trees:
        out.append({})
        for p, x in t.items():
            out[-1][p] = flat[at:at + x.numel()].view(x.shape)
            at += x.numel()
    return out


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    *,
    microbatches: int = 1,
    sparsity_taps: bool = False,
    dynamic_sparsity=None,
    guard_nonfinite: bool = False,
):
    """Returns ``train_step(params, opt_state, batch, masks=None, poison=None)
    -> (params, opt_state, metrics)``.

    ``batch`` is the global batch; with ``microbatches > 1`` it is split on
    its leading axis and the gradients are accumulated in fp32.  The
    parameters are updated in place and returned; the metrics are device
    scalars (``loss``, ``grad_norm``, ``param_norm``; ``lr`` is a float),
    plus ``A_density``/``G_density`` vectors and ``modeled_speedup`` with
    ``sparsity_taps`` (averaged over microbatches).

    ``guard_nonfinite=True`` checks ``isfinite(loss) & isfinite(grad_norm)``
    (one host sync) and skips a non-finite step: parameters and optimizer
    state stay as they were and ``metrics["nonfinite"]`` is 1.  ``poison``
    is the fault-injection hook (0 clean, 1 NaN loss, 2 NaN gradients).

    ``dynamic_sparsity`` (a controller, or a ``{path: (bk, bn)}`` spec)
    makes ``masks`` (the controller's ``masks()``) required and follows the
    JAX package's order: mask the parameters (in place); compute the
    gradients; apply the poison; score the masked parameters and the
    unmasked gradients (``dst_w_scores``/``dst_g_scores``, block L1 masses
    keyed by path) and the live ``dst_density``; mask the gradients; run
    AdamW; mask the parameters again.  A skipped step returns the
    parameters it was given, as JAX's does: the blocks its mask had just
    zeroed get their values back (a later refresh may regrow them); it
    still reports the scores.  On a mesh ``masks`` are the global masks and
    the scores come back global, the same on every rank.
    """
    dst_spec = None
    if dynamic_sparsity is not None:
        dst_spec = (dynamic_sparsity.spec() if hasattr(dynamic_sparsity, "spec")
                    else dict(dynamic_sparsity))
    if sparsity_taps and (cfg.family not in ("dense", "moe") or cfg.frontend is not None):
        raise ValueError(
            f"sparsity_taps: unsupported family {cfg.family!r} / frontend {cfg.frontend!r} "
            "(taps probe the transformer MLP stacks)")
    rt = rtm.resolve()
    if rt.geometry == "auto" and (rt.tuning_db is None or len(rt.tuning_db) == 0):
        warnings.warn(
            "make_train_step under Runtime(geometry='auto') with an empty TuningDB: every cell "
            "resolves cold to the hand-tuned defaults", stacklevel=2)
    sh = tfm.shards_of(cfg, rt)
    specs = S.spec_leaves(sh.specs) if sh is not None else None
    norm = lambda tree: global_norm(tree, shards=sh, specs=specs)
    loss_fn = make_loss_fn(cfg)
    # the last clean dynamic step's _stamp, taken after its final mask: while
    # it holds, every masked-off block is zero and there is nothing to hold
    settled: list = []
    # on a mesh: where this rank's slices of each controlled leaf sit in the
    # global leaf, and whether it counts the leaf's partial scores
    place: dict = {}

    def cuts_of(params):
        if sh is None:
            return None
        if not place:
            cuts = leaf_cuts(params, sh.specs, S.rank_index(sh.policy))
            paths = [p for p in dst_spec if p in cuts]
            spec_of = stacked_leaves(sh.specs)
            place["cuts"] = {p: cuts[p] for p in paths}
            place["owner"] = dict(zip(paths, S.owner_mask([spec_of[p].leaves[0] for p in paths], sh)))
        return place["cuts"]

    def train_step(params, opt_state, batch, masks=None, poison=None):
        if dst_spec is not None:
            if masks is None:
                raise TypeError("dynamic_sparsity train step takes masks: "
                                "train_step(params, opt_state, batch, controller.masks())")
            cuts = cuts_of(params)
            held = []
            if guard_nonfinite and not _unchanged(settled, _stamp(params, masks)):
                held = _held_blocks(params, masks, dst_spec, cuts)
            apply_block_masks(params, masks, dst_spec, cuts)
        loss, grads, tapm = accumulate_grads(loss_fn, cfg, params, batch, microbatches=microbatches,
                                             sparsity_taps=sparsity_taps, shards=sh)
        metrics: dict = {}
        if guard_nonfinite:
            pc = int(poison or 0)
            if pc == 1:
                loss = loss + float("nan")
            elif pc == 2:
                grads = [g + float("nan") for g in grads]
        dstm = {}
        if dst_spec is not None:
            # scores before the grad mask: RigL regrows on the *dense*
            # gradient's block mass, prunes on the (masked) weights'.
            # Masking the grads pins pruned weights and their updates at 0
            gtree = tree_unflatten(params, grads)
            scores = [block_scores(params, dst_spec, cuts), block_scores(gtree, dst_spec, cuts)]
            if sh is not None:
                scores = _mesh_scores(scores, place["owner"], sh)
            dstm = {"dst_w_scores": scores[0], "dst_g_scores": scores[1],
                    "dst_density": mask_density(masks, dst_spec)}
            apply_block_masks(gtree, masks, dst_spec, cuts)
        gnorm = norm(grads)
        if guard_nonfinite:
            # the loss and the norm are global: every rank decides the same
            if not bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
                # skip: a non-finite loss or gradient leaves params and
                # optimizer state as they were
                if dst_spec is not None:
                    _restore_blocks(held)
                metrics.update(grad_norm=gnorm, lr=lr_at(opt_cfg, opt_state.step + 1), nonfinite=1)
                with torch.no_grad():
                    metrics.update(loss=loss, param_norm=norm(params), **tapm, **dstm)
                return params, opt_state, metrics
            metrics["nonfinite"] = 0
        # grads is a list in tree_leaves(params) order, which is how
        # apply_updates walks the params and moments
        params, opt_state, upd = apply_updates(params, grads, opt_state, opt_cfg, gnorm=gnorm)
        if dst_spec is not None:
            # stale Adam momentum would drift just-pruned entries off zero;
            # re-mask so stored weights carry exactly-zero blocks (what
            # makes value planning recover the mask by construction)
            apply_block_masks(params, masks, dst_spec, cuts)
            if guard_nonfinite:
                settled[:] = _stamp(params, masks)
        with torch.no_grad():
            metrics.update(upd, loss=loss, param_norm=norm(params), **tapm, **dstm)
        return params, opt_state, metrics

    return train_step
