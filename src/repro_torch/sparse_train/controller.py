"""RigL-style dynamic sparse training with incremental plan maintenance
(port of ``repro/sparse_train/controller.py``).

:class:`DynamicSparsityController` owns the evolving block masks of every
maskable weight (see :func:`repro_torch.sparse_train.masks.maskable`) and
the live :class:`~repro_torch.runtime.plan.SparsityPlan` pair each weight
executes with — the forward ``side="B"`` plan over ``w.T`` and the
transposed backward plan over ``w``.  Mask updates follow RigL (Evci et
al.): drop the lowest-|weight| active blocks, regrow the highest-|gradient|
inactive ones, on an update fraction that cosine-decays to zero while the
global sparsity rides the Zhu-Gupta cubic ramp
(``repro_torch.optim.sparsify.prune_schedule``).  Scores are *block* L1
masses at the runtime's plan geometry, so the mask is a plan block mask by
construction and every prune/regrow step is a sparse edit of CSR metadata —
applied through :func:`repro_torch.sparse_train.plan_edit.edit_plan` as a
work-queue splice, never a full replan.

Division of labour (the Graphcore dynamic-sparsity split): mask selection
and plan maintenance run host-side in numpy between steps, exactly as in
the JAX package; the device sees masked weights (in place) and the spliced
plans, whose metadata lives on the runtime's device.  The train step
computes the two score trees on the device
(``repro_torch.train.step.make_train_step(dynamic_sparsity=...)``), and
:meth:`DynamicSparsityController.update` fetches both in one
device-to-host copy.  Units, paths and masks follow the JAX package's
stacked leaves (:mod:`repro_torch.sparse_train.masks`).

On a mesh (a runtime whose ``sharding`` has a mesh) ``params`` are a rank's
shards and ``specs`` the spec tuples they were cut under: the units, their
block geometry and the masks are built from the global shapes, so they are
the JAX package's on every mesh, and every rank holds the same masks.  The
train step hands every rank the same global scores, the selection is
deterministic on them, and after each refresh one all-reduce of a checksum
of the masks (their kept count and CRC, MIN and MAX over the mesh) raises if
the ranks' masks differ.
"""
from __future__ import annotations

import dataclasses
import math
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import runtime as rtm
from repro_torch.parallel import sharding as S
from repro_torch.runtime.plan import _fit_block
from repro_torch.sparse_train import masks as mk
from repro_torch.sparse_train.plan_edit import PlanDelta, edit_plan, plan_from_block_mask

__all__ = ["DynamicSparsityConfig", "DynamicSparsityController"]


@dataclasses.dataclass(frozen=True)
class DynamicSparsityConfig:
    """RigL schedule knobs.

    ``target`` sparsity is reached via the cubic ramp over steps
    ``[begin, end]``; mask updates fire every ``update_every`` steps until
    ``t_end`` (default ``end``), with the prune/regrow churn fraction
    ``alpha`` cosine-decayed to zero at ``t_end`` so the topology anneals.
    """

    target: float = 0.9
    update_every: int = 100
    begin: int = 0
    end: int = 1000
    alpha: float = 0.3
    t_end: int | None = None
    min_size: int = 256
    exclude: tuple = ("embed",)

    def __post_init__(self):
        if not 0.0 <= self.target < 1.0:
            raise ValueError(f"target sparsity {self.target} not in [0, 1)")
        if self.update_every < 1:
            raise ValueError("update_every must be >= 1")

    @property
    def stop_step(self) -> int:
        return self.end if self.t_end is None else self.t_end

    def sparsity_at(self, step: int) -> float:
        """Scheduled global sparsity: the Zhu-Gupta cubic ramp."""
        from repro_torch.optim.sparsify import prune_schedule

        return float(prune_schedule(step, self.target, self.begin, self.end))

    def update_fraction(self, step: int) -> float:
        """RigL's cosine-decayed churn fraction ``alpha/2 (1 + cos(pi t/T))``."""
        t = min(max(step - self.begin, 0), max(self.stop_step - self.begin, 1))
        return self.alpha / 2.0 * (1.0 + math.cos(math.pi * t / max(self.stop_step - self.begin, 1)))


@dataclasses.dataclass
class _Unit:
    """One controlled weight: its mask and live plan pair per stacked layer."""

    path: str
    block: tuple[int, int]  # (bk', bn') — element block geometry
    lead: tuple  # scanned-stack lead dims of the weight leaf
    kb: int
    nb: int
    mask: np.ndarray  # [L, Kb, Nb] bool, L = prod(lead)
    fwd: list  # L forward plans (side="B", over w.T: [Nb, Kb] block rows)
    bwd: list  # L transposed backward plans (over w: [Kb, Nb] block rows)

    @property
    def layers(self) -> int:
        return self.mask.shape[0]


class DynamicSparsityController:
    """Holds every layer's mask as live CSR metadata; prune/regrow steps are
    delta edits to the cached work queues (see module docstring).

    ``rt`` (default: the ambient runtime) supplies the block geometry and
    the device the plans and masks live on and, when it carries a plan
    cache, each edit *refreshes* the cached entries under ``("dst", path,
    layer, "fwd"/"bwd")`` keys — stored with ``PlanCache.store(key,
    plan.idx, plan)``, so the plan's own ``idx`` tensor is the source a
    lookup must pass — and the cache never accumulates stale duplicates.
    ``params`` is read for shapes and dtypes only.  Under a runtime with a
    mesh they are this rank's shards and ``specs`` (required there) the
    spec tuples they were cut under (``policy.param_pspecs(param_specs(
    cfg))``, the same tree): the units are built from the global shapes.
    """

    def __init__(self, cfg: DynamicSparsityConfig, params, rt=None, *, specs=None):
        self.cfg = cfg
        self.rt = rtm.resolve(rt)
        self.units: dict[str, _Unit] = {}
        self.last_report: dict | None = None
        mesh = self.rt.mesh
        if mesh is not None and specs is None:
            raise ValueError("on a mesh the controller takes specs=: the spec tuples params were cut under")
        # on a mesh a leaf's Cut carries the global shape, all that is read of it
        cuts = {} if mesh is None else mk.leaf_cuts(params, specs, S.rank_index(self.rt.sharding))
        for path, leaf in mk.stacked_leaves(params).items():
            shape = cuts.get(path, leaf).shape
            if not mk.maskable(path, cuts.get(path, leaf), min_size=cfg.min_size, exclude=cfg.exclude):
                continue
            k, n = shape[-2], shape[-1]
            bk = _fit_block(self.rt.bk, k)
            bn = _fit_block(self.rt.bn, n)
            kb, nb = k // bk, n // bn
            lead = tuple(shape[:-2])
            layers = int(np.prod(lead, dtype=np.int64)) if lead else 1
            mask = np.ones((layers, kb, nb), bool)
            unit = _Unit(
                path=path, block=(bk, bn), lead=lead, kb=kb, nb=nb, mask=mask,
                fwd=[
                    plan_from_block_mask(
                        mask[l].T, bm=bn, bk=bk, shape=(n, k),
                        dtype=leaf.dtype, side="B", device=self.rt.device,
                    )
                    for l in range(layers)
                ],
                bwd=[
                    plan_from_block_mask(
                        mask[l], bm=bk, bk=bn, shape=(k, n), dtype=leaf.dtype,
                        device=self.rt.device,
                    )
                    for l in range(layers)
                ],
            )
            self.units[path] = unit
        if not self.units:
            raise ValueError(
                "dynamic sparsity found no maskable weights "
                f"(min_size={cfg.min_size}, exclude={cfg.exclude})"
            )
        self._refresh_cache()

    # -- views -------------------------------------------------------------
    def spec(self) -> dict:
        """Static ``{path: (bk', bn')}`` block geometry for the train step."""
        return {p: u.block for p, u in self.units.items()}

    def masks(self) -> dict:
        """Device block masks ``{path: bool [*lead, Kb, Nb]}`` on the
        runtime's device — the argument
        :func:`repro_torch.sparse_train.masks.apply_block_masks` takes."""
        return {
            p: torch.from_numpy(u.mask.reshape(*u.lead, u.kb, u.nb).copy()).to(self.rt.device)
            for p, u in self.units.items()
        }

    def plans(self, path: str, layer: int = 0):
        """The live ``(forward, backward)`` plan pair of one weight layer."""
        u = self.units[path]
        return u.fwd[layer], u.bwd[layer]

    def density(self) -> float:
        """Global fraction of weight elements still active (mask-weighted)."""
        num = sum(
            int(u.mask.sum()) * u.block[0] * u.block[1] for u in self.units.values()
        )
        den = sum(u.mask.size * u.block[0] * u.block[1] for u in self.units.values())
        return num / max(den, 1)

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def layer_densities(self) -> dict:
        """Per-unit live mask density — the sparsity-tap view."""
        return {p: float(u.mask.mean()) for p, u in self.units.items()}

    def should_update(self, step: int) -> bool:
        c = self.cfg
        if step < c.begin or step >= c.stop_step:
            return False
        return (step + 1 - c.begin) % c.update_every == 0

    # -- the RigL update ---------------------------------------------------
    def update(self, step: int, w_scores: dict, g_scores: dict | None = None) -> dict:
        """One prune/regrow step: returns the per-refresh report
        ``{step, sparsity, pruned, regrown, edit_ms, ...}``.

        ``w_scores``/``g_scores`` are the ``dst_w_scores``/``dst_g_scores``
        metric trees the dynamic train step emits (block L1 masses, shape
        ``[*lead, Kb, Nb]`` per path).  ``g_scores=None`` regrows by
        uniform-random-equivalent order (argpartition of zeros) — the
        pure-ramp mode benchmarks use.
        """
        s_target = self.cfg.sparsity_at(step)
        frac = self.cfg.update_fraction(step)
        pruned = regrown = 0
        t0 = time.perf_counter()
        # one transfer for both metric trees (float32 host arrays) — a
        # per-path copy inside the loop would round-trip the device once
        # per weight
        w_scores, g_scores = _host_trees(w_scores, g_scores)
        for path, u in self.units.items():
            ws = w_scores[path].reshape(u.layers, u.kb, u.nb)
            gs = (
                g_scores[path].reshape(u.layers, u.kb, u.nb)
                if g_scores is not None
                else np.zeros((u.layers, u.kb, u.nb), np.float32)
            )
            for l in range(u.layers):
                delta = self._select(u.mask[l], ws[l], gs[l], s_target, frac)
                if delta.size == 0:
                    continue
                pruned += len(delta.prune)
                regrown += len(delta.regrow)
                # weight-oriented delta edits the backward plan directly and
                # the forward (transposed-operand) plan swapped — one
                # selection, both schedules spliced (and, under the
                # runtime's validate policy, structurally verified)
                try:
                    u.bwd[l] = edit_plan(u.bwd[l], delta, validate=self.rt.validate)
                    u.fwd[l] = edit_plan(u.fwd[l], delta.swapped(), validate=self.rt.validate)
                except ValueError as e:
                    # (PlanVerificationError is a ValueError.)  When the
                    # delta is consistent with the mask — the controller's
                    # source of truth — the failure is plan-side corruption
                    # or splice damage: degrade LOUDLY to a from-scratch
                    # replan of the post-delta mask.  An inconsistent delta
                    # is a controller bug; re-raise.
                    if not self._delta_consistent(u.mask[l], delta):
                        raise
                    self._replan_from_scratch(u, l, delta, e)
                m = u.mask[l]
                if len(delta.prune):
                    m[delta.prune[:, 0], delta.prune[:, 1]] = False
                if len(delta.regrow):
                    m[delta.regrow[:, 0], delta.regrow[:, 1]] = True
        edit_ms = (time.perf_counter() - t0) * 1e3
        self._check_ranks_agree(step)
        self._refresh_cache()
        self.last_report = {
            "step": step,
            "sparsity": self.sparsity(),
            "target_sparsity": s_target,
            "update_fraction": frac,
            "pruned": pruned,
            "regrown": regrown,
            "edit_ms": edit_ms,
        }
        return self.last_report

    def _check_ranks_agree(self, step: int) -> None:
        """On a mesh of several ranks: raise unless every rank holds the
        same masks (one all-reduce of their kept count and CRC-32, MIN and
        MAX together)."""
        policy = self.rt.sharding
        if policy is None or policy.mesh is None or policy.size == 1:
            return
        kept, crc = 0, 0
        for u in self.units.values():
            kept += int(u.mask.sum())
            crc = zlib.crc32(np.packbits(u.mask).tobytes(), crc)
        mine = torch.tensor([kept, crc, -kept, -crc], dtype=torch.int64, device=self.rt.device)
        seen = S.mesh_all_reduce(mine, policy, op=dist.ReduceOp.MAX).tolist()  # lint: allow-host-sync: once a refresh
        if seen != [kept, crc, -kept, -crc]:
            raise RuntimeError(
                f"dynamic sparsity step {step}: the ranks' masks differ (kept count and CRC-32 over the mesh: "
                f"max {seen[:2]}, min {[-seen[2], -seen[3]]}, this rank's {[kept, crc]})")

    @staticmethod
    def _delta_consistent(mask, delta: PlanDelta) -> bool:
        """Is the delta applicable to the mask (prunes active, regrows
        inactive)?  Distinguishes plan-side corruption (recoverable — the
        mask is the source of truth) from controller drift (a bug)."""
        p, r = delta.prune, delta.regrow
        if len(p) and not mask[p[:, 0], p[:, 1]].all():
            return False
        if len(r) and mask[r[:, 0], r[:, 1]].any():
            return False
        return True

    def _replan_from_scratch(self, u: _Unit, l: int, delta: PlanDelta,
                             err: Exception) -> None:
        """Graceful degradation for a failed incremental edit: rebuild both
        of layer ``l``'s plans from the post-delta mask (bit-identical to
        what a successful splice would have produced — the incremental path
        is pinned to the from-scratch path by the plan-edit tests), warn,
        and record the event."""
        import warnings

        from repro_torch.resilience.log import record as _record

        warnings.warn(
            f"incremental plan edit failed for {u.path}[{l}] ({err}); "
            f"degrading to a from-scratch replan of the mask",
            RuntimeWarning, stacklevel=3,
        )
        _record("plan-corrupt", "sparse_train.edit_plan", "replan",
                path=u.path, layer=l, error=str(err))
        newmask = u.mask[l].copy()
        if len(delta.prune):
            newmask[delta.prune[:, 0], delta.prune[:, 1]] = False
        if len(delta.regrow):
            newmask[delta.regrow[:, 0], delta.regrow[:, 1]] = True
        bk, bn = u.block
        k, n = u.kb * bk, u.nb * bn
        dtype = u.bwd[l].dtype
        u.bwd[l] = plan_from_block_mask(
            newmask, bm=bk, bk=bn, shape=(k, n), dtype=dtype, device=self.rt.device
        )
        u.fwd[l] = plan_from_block_mask(
            newmask.T, bm=bn, bk=bk, shape=(n, k), dtype=dtype, side="B",
            device=self.rt.device,
        )

    @staticmethod
    def _select(mask, w_score, g_score, s_target: float, frac: float) -> PlanDelta:
        """RigL block selection for one layer's ``[Kb, Nb]`` mask.

        Prunes the lowest-|w| active blocks down to the scheduled budget
        plus the churn, regrows the highest-|g| previously-inactive blocks
        back up to the budget — so the active count lands exactly on the
        cubic ramp while ``frac`` of it turns over.
        """
        b = mask.size
        active = int(mask.sum())
        desired = max(int(round((1.0 - s_target) * b)), 1)
        shrink = max(active - desired, 0)
        churn = int(round(frac * min(desired, active)))
        # churn is a swap: every churned prune must be matched by a regrow
        # from the inactive pool, so cap it by the room left there (at full
        # density there is nothing to swap with — pruning would undershoot
        # the scheduled budget)
        churn = min(churn, b - max(active, desired))
        n_prune = min(active, shrink + churn)
        n_regrow = min(max(desired - (active - n_prune), 0), b - active)

        flat_w = np.where(mask.reshape(-1), w_score.reshape(-1), np.inf)
        flat_g = np.where(mask.reshape(-1), -np.inf, g_score.reshape(-1))
        prune = (
            np.argpartition(flat_w, n_prune - 1)[:n_prune]
            if n_prune else np.empty((0,), np.int64)
        )
        regrow = (
            np.argpartition(-flat_g, n_regrow - 1)[:n_regrow]
            if n_regrow else np.empty((0,), np.int64)
        )
        nb = mask.shape[1]
        return PlanDelta.make(
            np.stack([prune // nb, prune % nb], axis=1) if len(prune) else np.empty((0, 2)),
            np.stack([regrow // nb, regrow % nb], axis=1) if len(regrow) else np.empty((0, 2)),
        )

    def _refresh_cache(self) -> None:
        """(Re)store every live plan in the runtime's plan cache, anchored on
        the plan's own ``idx`` tensor; ``PlanCache.store`` pops an existing
        key before reinserting, so edits refresh entries in place."""
        cache = self.rt.plan_cache
        if cache is None:
            return
        for path, u in self.units.items():
            for l in range(u.layers):
                cache.store(("dst", path, l, "fwd"), u.fwd[l].idx, u.fwd[l])
                cache.store(("dst", path, l, "bwd"), u.bwd[l].idx, u.bwd[l])


def _host_trees(*trees):
    """``{path: float32 ndarray}`` copies of score trees (tensors or
    arrays), in one device-to-host copy: concatenated on the first leaf's
    device, then split on the host."""
    flat = [(i, p, torch.as_tensor(x)) for i, t in enumerate(trees) if t is not None
            for p, x in t.items()]
    out = [None if t is None else {} for t in trees]
    if not flat:
        return out
    dev = flat[0][2].device
    # lint: allow-host-sync: one bulk fetch of every score tree a refresh
    host = torch.cat([x.detach().reshape(-1).to(dev, torch.float32) for *_, x in flat]).cpu().numpy()
    at = 0
    for i, p, x in flat:
        out[i][p] = host[at:at + x.numel()].reshape(tuple(x.shape))
        at += x.numel()
    return out
