"""The measured policy search behind ``python -m repro_torch.tune`` (port
of ``repro/tune/search.py``).

HASS-style (PAPERS.md) hardware-aware search over the kernel policy vector
— ``(bm, bk, bn)`` tile geometry, grid family (``ragged``/``v2``/``v1``),
fuse-or-not, backend — one cell at a time.  Per cell the harness:

1. **enumerates** the candidate lattice (divisor-fitted to the operand
   shapes, deduplicated),
2. **prunes** it with an analytic cost prior whose sparse-speedup ceiling
   comes from the :mod:`repro_torch.core.perf_model` accelerator simulation
   (ranking only — the winner is always *measured*),
3. **times real executions** — best-of-N wall us of a call that ends in a
   device synchronize, after a warm-up call, with the plan built outside
   the timed region (production amortizes planning through the
   ``PlanCache``); a geometry the backend's kernels cannot take
   (``BackendCapabilityError``) is rejected, not measured,
4. **gates the numerics** after the ``repro_torch.analysis`` plan/grid
   static verifiers pass (:func:`_verify`).  On a backend whose planned
   outputs equal the ``dense`` backend's bit for bit (``dense``,
   ``reference``: the plain executors) the JAX rule holds: the candidate's
   output must be bit-identical to ``dense`` at its own geometry.  The
   ``cuda`` kernels sum each block in another order than a torch ``bmm``
   (split-K partials, ``fmaf`` chains), so there the rule keeps its intent —
   a tuned policy changes nothing beyond what its geometry implies — in
   two parts: the candidate must equal the *ragged cuda kernel at the same
   geometry* bit for bit (the grid families are bit-identical by design),
   and lie within the kernel tolerance of the plain executor
   (:func:`kernel_tolerance`).  (The hand-tuned *default* is exempt: it is
   the baseline an untuned ``Runtime`` executes regardless.)  And
5. **stores** the argmin (which always includes the hand-tuned default, so
   a stored policy is never slower than the default *on the machine that
   measured it*) into the :class:`~repro_torch.tune.db.TuningDB`.

Note on bit-identity: it holds *per candidate vs the reference backend at
that candidate's geometry*.  Two different ``(bm, bk)`` choices group the
K-accumulation differently and legitimately differ in the last ulps — which
is exactly why ``Runtime._resolved`` / ``PlannedVJP._bwd_policy`` pin
``bm/bk`` whenever a caller brings its own plan and only tune the lane
width and grid family there.

``seed_from_history`` bootstraps grid-family preferences from
``BENCH_history.jsonl`` trends (the ragged-vs-compacted micro trajectory)
without running the harness; such entries are marked ``source="history"``
and carry default geometry until properly measured.

Operands are drawn with numpy from ``seed`` (the JAX package's draws) and
placed on ``device``, the card unless the caller asks for the CPU; the DB's
platform must be that device's (:func:`~repro_torch.tune.db.platform_of`).
"""
from __future__ import annotations

import functools
import json
import os
import time

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.backends import BackendCapabilityError, KernelRequest, get_backend
from repro_torch.runtime.plan import _fit_block, plan_operand
from repro_torch.tune.db import OPS, TunedPolicy, TuningDB, platform_of

__all__ = [
    "STANDARD_MICRO_SHAPES",
    "STANDARD_DENSITIES",
    "candidate_policies",
    "prior_score",
    "make_operand",
    "kernel_tolerance",
    "measure_candidate",
    "tune_matmul",
    "tune_cells",
    "seed_from_history",
]

#: the JAX package's standard micro-bench matmul shapes (its
#: ``benchmarks/run.py``); the smoke CLI sweep runs exactly these.  The
#: third shape exceeds the hand-tuned default tile caps (bm=128, bn=128) in
#: both M and N, which is where per-platform tuning has real headroom: the
#: defaults are TPU-VMEM-sized, and on a grid-faithful executor a tile that
#: spans the operand halves the issued grid per doubled dimension.
STANDARD_MICRO_SHAPES = ((128, 256, 64), (64, 256, 128), (256, 512, 256))

#: density grid the offline CLI sweeps; 0.25 is the paper's typical
#: post-ReLU activation density regime, 1.0 the dense sanity row
STANDARD_DENSITIES = (0.25, 0.5, 1.0)

#: block-sparsity structure granularity of the synthetic tuning operands:
#: zeros are planted in 8x16 element tiles, so any candidate blocking sees
#: them (a coarser candidate block is only skippable when every covered
#: structure tile is zero — exactly the real fine-grained-sparsity penalty)
STRUCT = (8, 16)

#: candidate tiles deliberately extend PAST the hand-tuned defaults
#: (bm=128, bk=512, bn=128 — sized for a TPU VMEM budget): on platforms
#: without that constraint the measured optimum at larger shapes is often a
#: bigger tile, and finding that is the point of tuning per platform
_BMS = (8, 16, 32, 64, 128, 256)
_BKS = (16, 32, 64, 128, 256, 512, 1024, 2048)
_BNS = (16, 32, 64, 128, 256)
_MODES = ("ragged", "v2", "v1")


def default_policy(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The hand-tuned default geometry after the shape clamp — what a
    default ``Runtime()`` (bm=128, bk=512, bn=128) actually executes at
    this shape, and the baseline every tuned cell must beat."""
    from repro_torch.runtime.runtime import Runtime

    rt = Runtime()
    return _fit_block(rt.bm, m), _fit_block(rt.bk, k), _fit_block(rt.bn, n)


def candidate_policies(m: int, k: int, n: int) -> list[dict]:
    """The deduplicated candidate lattice for one shape: every fitted
    ``(bm, bk, bn)`` x grid family, the hand-tuned default included."""
    seen, cands = set(), []
    bm_d, bk_d, bn_d = default_policy(m, k, n)
    # the default, plus the operand-spanning tile (one grid step per mode)
    # so every shape has a beyond-the-lattice giant candidate
    geoms = [(bm_d, bk_d, bn_d), (m, k, n)]
    for bm in _BMS:
        for bk in _BKS:
            for bn in _BNS:
                geoms.append((_fit_block(bm, m), _fit_block(bk, k),
                              _fit_block(bn, n)))
    for bm, bk, bn in geoms:
        for mode in _MODES:
            key = (bm, bk, bn, mode)
            if key not in seen:
                seen.add(key)
                cands.append(dict(bm=bm, bk=bk, bn=bn, compact_grid=mode))
    return cands


@functools.lru_cache(maxsize=256)
def _modeled_speedup(k: int, n: int, density: float, device: str = "cuda") -> float:
    """The perf_model ceiling: TensorDash's simulated FWD speedup for an FC
    layer of this contraction at this operand density — how much sparse
    savings the paper's accelerator model says is *credible* here.  Used to
    bound the prior's sparse-mode optimism, never to pick a winner.  The
    tile simulator runs on ``device``, where the tune run measures."""
    from repro_torch.core.perf_model import (
        BWD_INPUT,
        BWD_WEIGHT,
        FWD,
        ConvLayer,
        model_speedup,
    )

    layer = ConvLayer(name="tune", c_in=k, kx=1, ky=1, c_out=n, ox=1, oy=1)
    res = model_speedup([layer], {
        FWD: 1.0 - density, BWD_INPUT: 0.0, BWD_WEIGHT: 0.0,
    }, device=device)
    return max(float(res[FWD]), 1.0)


def prior_score(m: int, k: int, n: int, *, bm: int, bk: int, bn: int,
                compact_grid: str, density: float | None, device: str = "cuda") -> float:
    """Analytic expected cost of one candidate — a *ranking* prior for
    pruning, in arbitrary units.  Models: the expected effectual-block
    fraction at this blocking (a candidate block is skippable only when
    every covered :data:`STRUCT` tile is zero), per-mode issued grid steps
    (ragged = effectual work, v2 = ``max(nnz)``-bounded with a skew term,
    v1 = the full gated grid), a per-step dispatch overhead that penalizes
    tiny blocks, and the :func:`_modeled_speedup` ceiling capping how much
    sparse benefit is credible (its tile simulator on ``device``)."""
    d = 1.0 if density is None else float(density)
    mb, kb, nb = m // bm, k // bk, n // bn
    covered = max(1, (bm // STRUCT[0]) * (bk // STRUCT[1]))
    p_eff = 1.0 - (1.0 - d) ** covered  # P[candidate block effectual]
    block_cost = bm * bk * bn  # MACs per issued step
    # dispatch/prefetch cost per issued step, in MAC-units.  Deliberately
    # large: every executor this repo ships is dispatch-dominated at micro
    # scale (grid-step interpretation, per-step einsum launch), so tiny
    # blocks pay a tax the MAC count alone would hide.
    step_overhead = 16384.0
    dense_steps = mb * kb * nb
    if compact_grid == "v1":
        # full gated grid: a gated step skips the MACs but not the dispatch
        steps = dense_steps
        cost = dense_steps * (p_eff * block_cost + step_overhead)
    elif compact_grid == "v2":
        # grid bound = E[max(nnz)] over mb rows of ~Binomial(kb, p_eff):
        # mean + 2 sigma — one dense-ish row drags every row with it
        max_nnz = min(1.0, p_eff + 2.0 * (p_eff * (1 - p_eff) / max(kb, 1)) ** 0.5)
        steps = mb * nb * max(1.0, max_nnz * kb)
        cost = steps * (block_cost + step_overhead)
    else:  # ragged: steps track effectual work exactly (>= 1 per row)
        steps = nb * max(mb * kb * p_eff, mb)
        cost = steps * (block_cost + step_overhead)
    # the accelerator model bounds credible sparse savings from below
    floor = dense_steps * (block_cost + step_overhead) / _modeled_speedup(k, n, d, device)
    return max(cost, floor) + steps * 1e-6  # tiebreak: fewer steps


def make_operand(m: int, k: int, density: float | None, *, dtype=torch.float32,
                 seed: int = 0, device="cuda"):
    """A synthetic tuning operand with ``density`` of its :data:`STRUCT`
    tiles non-zero (``None``/1.0 = dense), on ``device``.  Values are O(1)
    normals so bit comparisons exercise real mantissas."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    d = 1.0 if density is None else float(density)
    if d < 1.0:
        sm, sk = STRUCT[0], STRUCT[1]
        mt, kt = max(m // sm, 1), max(k // sk, 1)
        keep = rng.random((mt, kt)) < d
        mask = np.repeat(np.repeat(keep, sm, axis=0), sk, axis=1)[:m, :k]
        a = a * mask
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _sync(x, device: torch.device):
    """Wait for the device work behind ``x`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return x


def _best_of(fn, reps: int = 20) -> float:
    """Best-of-``reps`` wall us (the minimum is reproducible; a mean is
    scheduler jitter on shared hosts).  ``fn`` synchronizes the device."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def kernel_tolerance(dtype, ref: torch.Tensor) -> tuple[float, float]:
    """``(rtol, atol)`` of a CUDA kernel against its plain executor: fp32
    rtol = atol = 2e-4 (TF32 off; the JAX suite's bound for planned
    products against dense math); bf16 one bf16 step (rtol 2**-7) plus atol
    1e-3 of the largest value, since both sum the same fp32 products in
    another order and the bf16 rounding of the result may flip a step."""
    if dtype == torch.float32:
        return 2e-4, 2e-4
    return 2**-7, 1e-3 * float(ref.float().abs().max())  # lint: allow-host-sync: offline tuner


class CandidateRejected(RuntimeError):
    """A candidate failed static verification or bit-identity — it can
    never be stored, whatever its wall-clock."""


def _verify(plan, req: KernelRequest, out, be) -> None:
    """The tuner's numerics gate: ``repro_torch.analysis`` static plan/grid
    verification of the launch's grid, then on a ``bitwise_dense`` backend
    bit-identity with ``dense`` at the candidate's own geometry, and on
    another (``cuda``) bit-identity with the backend's own ragged family at
    that geometry plus the kernel tolerance against ``dense``."""
    from repro_torch.analysis.grid_check import check_plan_grid
    from repro_torch.analysis.plan_check import verify_plan
    from repro_torch.kernels.tensordash_spmm import launch_splits

    m, n = req.a.shape[0], req.b.shape[1]
    splits = (launch_splits(m, req.a.shape[1], n, req.bm, req.bk, req.bn, req.a.device, req.a.dtype)
              if req.a.device.type == "cuda" else 1)
    findings = list(verify_plan(plan, level="full"))
    findings += check_plan_grid(plan, nb=n // req.bn, compact_grid=req.compact_grid,
                                splits=splits)
    if findings:
        raise CandidateRejected(f"static verification: {findings}")
    where = f"bm={req.bm} bk={req.bk} bn={req.bn} compact_grid={req.compact_grid}"
    ref = get_backend("dense").execute_planned(req)
    if ref.dtype != out.dtype or ref.shape != out.shape:
        raise CandidateRejected(f"output {out.dtype} {tuple(out.shape)} != reference's at {where}")
    if be.bitwise_dense:
        if not torch.equal(ref, out):
            raise CandidateRejected(
                f"output not bit-identical to the reference backend at {where}")
        return
    ragged = be.execute_planned(dataclasses.replace(
        req, compact_grid="ragged", workqueue=plan.workqueue()))
    if not torch.equal(ragged, out):
        raise CandidateRejected(
            f"output not bit-identical to the backend's ragged family at {where}")
    rtol, atol = kernel_tolerance(out.dtype, ref)
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        err = float((out.float() - ref.float()).abs().max())
        raise CandidateRejected(
            f"output outside the kernel tolerance of the plain executor at {where} "
            f"(max abs err {err})")


def measure_candidate(a, b, *, bm: int, bk: int, bn: int, compact_grid: str,
                      backend: str = "cuda", reps: int = 10,
                      verify: bool = True) -> float:
    """Best-of-``reps`` wall us of one candidate execution, warm (one
    untimed call builds/caches), after the numerics gate.  Raises
    :class:`CandidateRejected` when verification fails or the backend
    cannot take the geometry."""
    plan = plan_operand(a, bm, bk)
    req = KernelRequest(
        nnz=plan.nnz, idx=plan.idx, a=a, b=b, bm=bm, bk=bk, bn=bn,
        out_dtype=a.dtype, compact_grid=compact_grid,
        workqueue=plan.workqueue() if compact_grid == "ragged" else None,
    )
    be = get_backend(backend)
    try:
        out = _sync(be.execute_planned(req), a.device)  # warm + verify run
    except BackendCapabilityError as e:
        raise CandidateRejected(f"backend {backend!r} cannot take it: {e}") from None
    if verify:
        _verify(plan, req, out, be)
    return _best_of(lambda: _sync(be.execute_planned(req), a.device), reps=reps)


def tune_matmul(db: TuningDB, m: int, k: int, n: int, *,
                dtype=torch.float32, density: float | None = 0.5,
                op: str = "matmul", backend: str = "cuda", device="cuda",
                reps: int = 10, keep: int = 10, seed: int = 0,
                log=None, trials: list | None = None) -> TunedPolicy:
    """Search one cell and store the measured-best policy.

    The prior keeps the ``keep`` best-ranked candidates plus the hand-tuned
    default (always measured, so the stored policy's :attr:`~repro_torch.
    tune.db.TunedPolicy.speedup` >= 1 by construction on this machine).
    Rejected candidates (failed numerics gate, static checks or a geometry
    the backend cannot take) are skipped, not stored.  ``trials``, when
    given, receives one dict per measured candidate: its policy plus ``us``
    or ``rejected`` (the reason)."""
    device = torch.device(device)
    if platform_of(device) != db.platform:
        raise ValueError(f"measuring on {platform_of(device)!r} into a DB for {db.platform!r}")
    a = make_operand(m, k, density, dtype=dtype, seed=seed, device=device)
    b = torch.from_numpy(
        np.random.default_rng(seed + 1).standard_normal((k, n)).astype(np.float32)
    ).to(device=device, dtype=dtype)
    cands = candidate_policies(m, k, n)
    bm_d, bk_d, bn_d = default_policy(m, k, n)
    is_default = lambda c: (c["bm"], c["bk"], c["bn"]) == (bm_d, bk_d, bn_d) \
        and c["compact_grid"] == "ragged"
    # anchors bypass the prior prune: the hand-tuned default (the baseline
    # every stored cell is scored against) and the operand-spanning giant
    # tile (the platform-specific optimum the TPU-sized defaults cap away)
    is_anchor = lambda c: is_default(c) or (c["bm"], c["bk"], c["bn"]) == (m, k, n)
    cands.sort(key=lambda c: prior_score(m, k, n, density=density, device=str(device), **c))
    kept = [c for c in cands[:keep]] + [c for c in cands[keep:] if is_anchor(c)]
    timed, default_us = [], None
    for c in kept:
        try:
            # the default is the *baseline*, not a candidate promotion:
            # storing it cannot change what an untuned Runtime executes, so
            # it skips the numerics gate.  Every NON-default stored policy
            # must pass the full gate.
            us = measure_candidate(a, b, backend=backend, reps=reps,
                                   verify=not is_default(c), **c)
        except CandidateRejected as e:
            if trials is not None:
                trials.append({**c, "rejected": str(e)})
            if log:
                log(f"  reject {c}: {e}")
            continue
        if trials is not None:
            trials.append({**c, "us": us})
        timed.append((us, c))
        if is_default(c):
            default_us = us
        if log:
            log(f"  {c['bm']:>3}x{c['bk']:>3}x{c['bn']:>3} "
                f"{c['compact_grid']:<6} {us:9.1f}us")
    if not timed:
        raise RuntimeError(f"tune_matmul({m},{k},{n}): every candidate rejected")
    best_us, best = min(timed, key=lambda t: t[0])
    if default_us is None:  # default was pruned out of the measured pool
        default_us = measure_candidate(
            a, b, bm=bm_d, bk=bk_d, bn=bn_d, compact_grid="ragged",
            backend=backend, reps=reps, verify=False,
        )
    pol = TunedPolicy(
        bm=best["bm"], bk=best["bk"], bn=best["bn"],
        compact_grid=best["compact_grid"], fuse=True, backend=backend,
        measured_us=best_us, default_us=default_us, source="measured",
    )
    key = db.key(op=op, m=m, k=k, n=n, dtype=dtype, density=density)
    db.store(key, pol)
    return pol


def tune_cells(db: TuningDB, shapes=STANDARD_MICRO_SHAPES, *,
               densities=STANDARD_DENSITIES, ops=("matmul",),
               dtype=torch.float32, backend: str = "cuda", device="cuda",
               reps: int = 10, keep: int = 10, log=print,
               trials: list | None = None) -> int:
    """Sweep the (shape x density x op) grid; each measured cell is also
    aliased into the ``"any"`` density bucket when it is the best measured
    speedup for its shape so far (what an unhinted ``Runtime`` lookup
    resolves).  Returns the number of cells stored."""
    stored = 0
    best_any: dict[tuple, tuple[float, TunedPolicy, object]] = {}
    for (m, k, n) in shapes:
        for density in densities:
            for op in ops:
                if op not in OPS:
                    raise ValueError(f"op {op!r} not one of {OPS}")
                if log:
                    log(f"tune {op} {m}x{k}x{n} density={density} "
                        f"dtype={str(dtype).removeprefix('torch.')}")
                pol = tune_matmul(
                    db, m, k, n, dtype=dtype, density=density, op=op,
                    backend=backend, device=device, reps=reps, keep=keep,
                    log=log, trials=trials,
                )
                stored += 1
                if log:
                    log(f"  -> best {pol.bm}x{pol.bk}x{pol.bn} "
                        f"{pol.compact_grid} {pol.measured_us:.1f}us "
                        f"({pol.speedup:.2f}x default)")
                akey = (op, m, k, n)
                cur = best_any.get(akey)
                if cur is None or pol.speedup > cur[0]:
                    any_key = db.key(op=op, m=m, k=k, n=n, dtype=dtype,
                                     density=None)
                    best_any[akey] = (pol.speedup, pol, any_key)
                    db.store(any_key, pol)
                    stored += 1
    return stored


def seed_from_history(db: TuningDB, path: str = "BENCH_history.jsonl", *,
                      last: int = 8, log=None) -> int:
    """Bootstrap grid-family preferences from ``BENCH_history.jsonl``: when
    the recent same-platform trend shows the ragged work-queue micro
    consistently beating the v2 compacted micro (or vice versa), seed that
    mode — default geometry, ``source="history"`` — into the standard
    micro cells that have no measured entry yet.  Never overwrites a
    measured cell; returns the number of cells seeded."""
    if not os.path.exists(path):
        return 0
    snaps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    snaps.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn concurrent append
    ragged = [s["benches"]["spmm_ragged_micro"] for s in snaps[-last:]
              if "spmm_ragged_micro" in s.get("benches", {})]
    v2 = [s["benches"]["spmm_compacted_micro"] for s in snaps[-last:]
          if "spmm_compacted_micro" in s.get("benches", {})]
    if len(ragged) < 2 or len(v2) < 2:
        return 0
    mode = "ragged" if float(np.median(ragged)) <= float(np.median(v2)) else "v2"
    if log:
        log(f"history trend ({len(ragged)}/{len(v2)} snaps): "
            f"median ragged {np.median(ragged):.0f}us vs v2 "
            f"{np.median(v2):.0f}us -> seeding {mode!r}")
    seeded = 0
    for (m, k, n) in STANDARD_MICRO_SHAPES:
        bm, bk, bn = default_policy(m, k, n)
        for density in (*STANDARD_DENSITIES, None):
            key = db.key(op="matmul", m=m, k=k, n=n, dtype=torch.float32,
                         density=density)
            if db.lookup(key) is not None:
                continue
            db.store(key, TunedPolicy(
                bm=bm, bk=bk, bn=bn, compact_grid=mode, source="history",
            ))
            seeded += 1
    return seeded
