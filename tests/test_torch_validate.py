"""Plan validation in the port against the JAX package's, on the CPU.

``Runtime(validate=...)`` and its levels, the ``PlanCache`` store-time
check, ``PlanCache.scrub`` after the same seeded ``corrupt_cache_entry``
(the same keys evicted in both packages), the ``matmul``/``matmul_fused``
boundary recovery of a corrupt caller plan (the warning, the resilience
event, an output equal to the clean run's and within fp32 rtol = atol =
1e-5 of JAX's), the sharded launch check, the controller and ``edit_plan``
taking their level from the runtime, and ``verify_transpose`` /
``verify_shards`` / ``check_sharded`` giving JAX's finding codes on the
mutants of ``tests/test_analysis.py``.  No check runs while a CUDA graph is
being captured: a spy stands in for ``torch.cuda.is_current_stream_capturing``.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.analysis import check_sharded as jcheck_sharded
from repro.analysis import verify_shards as jverify_shards
from repro.analysis import verify_transpose as jverify_transpose
from repro.analysis.plan_check import LEVELS as JLEVELS
from repro.resilience import faults as jfaults
from repro.resilience import log as jlog
from repro.runtime.plan import shard_plan as jshard_plan
from repro.sparse_train import plan_edit as jplan_edit
from repro_torch import runtime as trt
from repro_torch.analysis import (
    PlanVerificationError,
    check_grid,
    check_sharded,
    verify_plan,
    verify_shards,
    verify_transpose,
)
from repro_torch.analysis.plan_check import LEVELS
from repro_torch.parallel.spmm import _validate_launch
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import log as tlog
from repro_torch.runtime.plan import PlanCache, SparsityPlan, shard_plan
from repro_torch.sparse_train import plan_edit as tplan_edit

GEOM = dict(bm=8, bk=16, bn=16)


def _codes(findings):
    return sorted({f.code for f in findings})


def _mask_plans(seed, rb=12, kb=16, bm=8, bk=8, density=0.35):
    """The same block-mask plan in both packages."""
    mask = np.random.default_rng(seed).random((rb, kb)) < density
    kw = dict(bm=bm, bk=bk, shape=(rb * bm, kb * bk))
    return (jplan_edit.plan_from_block_mask(mask, dtype=np.float32, **kw),
            tplan_edit.plan_from_block_mask(mask, dtype=torch.float32, **kw), mask)


def _replace(plan, **fields):
    """A torch plan with some metadata replaced by numpy arrays."""
    return dataclasses.replace(plan, _host={}, **{k: torch.from_numpy(np.ascontiguousarray(v))
                                                   for k, v in fields.items()})


def _block_sparse(rng, m, k, bm, bk, density):
    a = rng.standard_normal((m, k)).astype(np.float32)
    keep = rng.random((m // bm, k // bk)) < density
    return (a.reshape(m // bm, bm, k // bk, bk) * keep[:, None, :, None]).reshape(m, k)


# ---------------------------------------------------------------------------
# the levels
# ---------------------------------------------------------------------------


def test_runtime_validate_levels():
    assert LEVELS == JLEVELS
    assert trt.Runtime(device="cpu").validate == "off"
    rt = trt.Runtime(device="cpu", validate="boundary")
    assert rt.plan_cache.validate == "boundary"
    assert rt.replace(validate="full").plan_cache.validate == "full"
    for level in ("paranoid", "", "Full"):
        with pytest.raises(ValueError):
            trt.Runtime(device="cpu", validate=level)


def test_plan_cache_store_validates():
    _, plan, _ = _mask_plans(0)
    a = torch.zeros(plan.shape)
    cache = PlanCache(validate="full")
    assert cache.store("w", a, plan) is plan
    rs = plan.row_starts.numpy().copy()
    rs[1] += 1
    bad = _replace(plan, row_starts=rs)
    with pytest.raises(PlanVerificationError) as ei:
        cache.store("w2", a, bad)
    assert any(f.code == "plan.row-starts" for f in ei.value.findings)
    PlanCache().store("w2", a, bad)  # off by default: accepted silently


def test_runtime_plan_path_validates_at_store():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_block_sparse(rng, 64, 128, 8, 16, 0.4))
    rt = trt.Runtime(backend="reference", device="cpu", validate="full", **GEOM)
    plan = rt.plan(a, key="w")
    assert verify_plan(plan) == [] and rt.plan_cache.misses == 1


# ---------------------------------------------------------------------------
# scrub after the same seeded corruption
# ---------------------------------------------------------------------------


def _filled_caches():
    rng = np.random.default_rng(7)
    jr = jrt.Runtime(backend="reference", **GEOM)
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    for i in range(5):
        a = _block_sparse(rng, 32, 64, 8, 16, 0.5)
        jr.plan(jnp.asarray(a), key=f"w{i}")
        tr.plan(torch.from_numpy(a), key=f"w{i}")
    return jr.plan_cache, tr.plan_cache


@pytest.mark.parametrize("level", ["boundary", "full"])
@pytest.mark.parametrize("mode", list(tfaults.PLAN_CORRUPTIONS))
def test_scrub_evicts_what_jax_evicts(mode, level):
    jcache, tcache = _filled_caches()
    jk = jfaults.corrupt_cache_entry(jcache, rng=np.random.default_rng(3), mode=mode)
    tk = tfaults.corrupt_cache_entry(tcache, rng=np.random.default_rng(3), mode=mode)
    assert jk[0] == tk[0]
    jbad, tbad = jcache.scrub(level=level), tcache.scrub(level=level)
    assert [k[0] for k, _ in tbad] == [k[0] for k, _ in jbad]
    # the content faults need the full tier
    assert len(tbad) == int(level == "full" or mode in ("nnz-range", "row-starts"))
    assert sorted(k[0] for k in tcache._entries) == sorted(k[0] for k in jcache._entries)
    assert tcache.scrub(level=level) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scrub_after_a_seeded_random_corruption(seed):
    jcache, tcache = _filled_caches()
    jfaults.corrupt_cache_entry(jcache, rng=np.random.default_rng(seed))
    tfaults.corrupt_cache_entry(tcache, rng=np.random.default_rng(seed))
    jbad, tbad = jcache.scrub(), tcache.scrub()
    assert [k[0] for k, _ in tbad] == [k[0] for k, _ in jbad] and len(tbad) == 1
    assert len(tcache) == 4


# ---------------------------------------------------------------------------
# a corrupt caller plan at the matmul boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(tfaults.PLAN_CORRUPTIONS))
@pytest.mark.parametrize("call", ["side_a", "side_b", "fused"])
def test_a_corrupt_caller_plan_warns_and_replans(call, mode):
    rng = np.random.default_rng(11)
    a = _block_sparse(rng, 32, 64, 8, 16, 0.5)
    b = rng.standard_normal((64, 48)).astype(np.float32)
    if call == "side_b":
        a, b = rng.standard_normal((24, 32)).astype(np.float32), _block_sparse(rng, 32, 64, 16, 16, 0.5)
    jr = jrt.Runtime(backend="reference", validate="full", **GEOM)
    tr = trt.Runtime(backend="reference", device="cpu", validate="full", **GEOM)

    def run(rt, aa, bb, plan, mod):
        if call == "fused":
            return rt.matmul_fused(aa, bb, plan=plan, activation="relu")[0]
        return rt.matmul(aa, bb, plan=plan, side="B" if call == "side_b" else "A")

    outs = []
    for rt, mod, lg, f, asarr in ((jr, jfaults, jlog, jnp.asarray, np.asarray),
                                  (tr, tfaults, tlog, torch.from_numpy, lambda t: t.numpy())):
        aa, bb = f(a), f(b)
        clean = rt.plan(bb, side="B") if call == "side_b" else rt.plan(aa)
        bad = mod.corrupt_plan(clean, rng=np.random.default_rng(0), mode=mode)
        log = lg.ResilienceLog()
        with lg.use_log(log), pytest.warns(RuntimeWarning, match="corrupt SparsityPlan"):
            out = run(rt, aa, bb, bad, mod)
        assert log.counts() == {("plan-corrupt", "replan"): 1}
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            want = run(rt, aa, bb, clean, mod)  # a clean plan passes silently
        np.testing.assert_array_equal(asarr(out), asarr(want))
        outs.append(asarr(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_validate_off_trusts_the_caller_plan():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(_block_sparse(rng, 32, 64, 8, 16, 0.5))
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    rt = trt.Runtime(backend="reference", device="cpu", **GEOM)
    bad = tfaults.corrupt_plan(rt.plan(a), rng=np.random.default_rng(0), mode="row-starts")
    assert rt._recovered_plan(bad, a) is bad


# ---------------------------------------------------------------------------
# the sharded launch, the controller and edit_plan take the runtime's level
# ---------------------------------------------------------------------------


def test_sharded_launch_boundary_validates():
    _, plan, _ = _mask_plans(2)
    _validate_launch(plan, "full")
    rs = plan.row_starts.numpy().copy()
    rs[1] += 1
    bad = _replace(plan, row_starts=rs)
    _validate_launch(bad, "off")
    with pytest.raises(PlanVerificationError):
        _validate_launch(bad, "boundary")
    with trt.use(trt.Runtime(device="cpu", validate="boundary")):
        with pytest.raises(PlanVerificationError):
            _validate_launch(bad, None)
    _validate_launch(bad, None)  # the default runtime's level is "off"


def test_edit_plan_takes_the_ambient_level():
    _, plan, mask = _mask_plans(1, rb=16, kb=12, bm=4, bk=4)
    act, ina = np.argwhere(mask), np.argwhere(~mask)
    delta = tplan_edit.PlanDelta.make(act[:1], ina[:1])
    wk = plan.work_kblk.numpy().copy()
    t0 = int(plan.row_starts[15])
    wk[t0] = (wk[t0] + 1) % plan.k_blocks  # a segment the splice copies through
    bad = _replace(plan, work_kblk=wk)
    tplan_edit.edit_plan(bad, delta)  # the default level is "off"
    with pytest.raises(PlanVerificationError):
        tplan_edit.edit_plan(bad, delta, validate="full")
    with trt.use(trt.Runtime(device="cpu", validate="full")):
        with pytest.raises(PlanVerificationError):
            tplan_edit.edit_plan(bad, delta)


@pytest.mark.parametrize("level", ["off", "boundary", "full"])
def test_controller_reads_runtime_validate(level, monkeypatch):
    from repro_torch.analysis import plan_check
    from repro_torch.sparse_train.controller import DynamicSparsityConfig, DynamicSparsityController

    seen = []
    real = plan_check.check_plan
    monkeypatch.setattr(plan_check, "check_plan",
                        lambda plan, geometry=None, *, level="full": (seen.append(level),
                                                                      real(plan, geometry, level=level)))
    params = {"w": torch.zeros((64, 64))}
    cfg = DynamicSparsityConfig(target=0.5, update_every=1, begin=0, end=4, min_size=16)
    rt = trt.Runtime(device="cpu", bm=16, bk=16, bn=16, validate=level)
    ctl = DynamicSparsityController(cfg, params, rt)
    rng = np.random.default_rng(0)
    scores = {p: torch.from_numpy(rng.random((u.kb, u.nb)).astype(np.float32))
              for p, u in ctl.units.items()}
    seen.clear()
    report = ctl.update(4, scores)
    assert report["pruned"] > 0
    assert set(seen) == (set() if level == "off" else {level}) and (level == "off") == (not seen)
    for u in ctl.units.values():
        for p in u.fwd + u.bwd:
            assert verify_plan(p) == []


# ---------------------------------------------------------------------------
# no check while a CUDA graph is captured
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capturing", [True, False])
def test_no_check_runs_while_capturing(capturing, monkeypatch):
    calls = []

    def spy():
        calls.append(True)
        return capturing

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", spy)
    _, plan, _ = _mask_plans(4)
    rs = plan.row_starts.numpy().copy()
    rs[2] += 1
    bad = _replace(plan, row_starts=rs)
    a = torch.zeros(plan.shape)
    rt = trt.Runtime(backend="reference", device="cpu", validate="full", bm=8, bk=8)
    checks = (lambda: rt.plan_cache.store("w", a, bad), lambda: _validate_launch(bad, "full"),
              lambda: rt._recovered_plan(bad, a))
    for check in checks:
        if capturing:
            check()  # skipped: a check would read the device from the host
        else:
            with pytest.raises(PlanVerificationError) if check is not checks[2] else \
                    pytest.warns(RuntimeWarning):
                check()
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# verify_transpose / verify_shards / check_sharded: JAX's findings
# ---------------------------------------------------------------------------


def test_transpose_findings_equal_jax():
    from repro.runtime.plan import SparsityPlan as JPlan
    from repro_torch.kernels.tensordash_spmm import transpose_plan_csr

    jplan, plan, mask = _mask_plans(2)
    nnz_t, idx_t, rs, wr, wk = transpose_plan_csr(plan.nnz, plan.idx)
    plan_t = SparsityPlan(nnz=nnz_t, idx=idx_t, bm=plan.bk, bk=plan.bm,
                          shape=(plan.shape[1], plan.shape[0]), dtype=plan.dtype,
                          row_starts=rs, work_row=wr, work_kblk=wk)
    jplan_t = JPlan(nnz=nnz_t.numpy(), idx=idx_t.numpy(), bm=plan.bk, bk=plan.bm,
                    shape=plan_t.shape, dtype=np.float32, row_starts=rs.numpy(),
                    work_row=wr.numpy(), work_kblk=wk.numpy())
    assert verify_transpose(plan, plan_t) == [] == jverify_transpose(jplan, jplan_t)
    flipped = mask.T.copy()
    flipped[0, 0] = not flipped[0, 0]
    kw = dict(bm=plan.bk, bk=plan.bm, shape=plan_t.shape)
    stale = tplan_edit.plan_from_block_mask(flipped, dtype=torch.float32, **kw)
    jstale = jplan_edit.plan_from_block_mask(flipped, dtype=np.float32, **kw)
    assert _codes(verify_transpose(plan, stale)) == ["plan.transpose"]
    assert _codes(verify_transpose(plan, stale)) == _codes(jverify_transpose(jplan, jstale))
    rs_bad = rs.numpy().copy()
    rs_bad[1] += 1
    f = verify_transpose(plan, _replace(plan_t, row_starts=rs_bad))
    jf = jverify_transpose(jplan, dataclasses.replace(jplan_t, row_starts=rs_bad))
    assert [(x.code, x.where) for x in f] == [(x.code, x.where) for x in jf]
    assert f[0].where == ("transpose",)


@pytest.mark.parametrize("axis", ["M", "N", "K"])
@pytest.mark.parametrize("balance", [True, False])
def test_shard_findings_clean_in_both(axis, balance):
    jplan, plan, _ = _mask_plans(3)
    shards, jshards = shard_plan(plan, 4, axis=axis, balance=balance), jshard_plan(jplan, 4, axis=axis,
                                                                                 balance=balance)
    assert verify_shards(shards) == [] == jverify_shards(jshards)
    assert check_sharded(shards, nb=2) == [] == jcheck_sharded(jshards, nb=2)
    assert verify_shards(shards, level="off") == []


def test_sharded_mutant_order_not_a_permutation():
    jplan, plan, _ = _mask_plans(7)
    shards, jshards = shard_plan(plan, 4, axis="M"), jshard_plan(jplan, 4, axis="M")
    order = np.asarray(shards.order).copy()
    order[0] = order[1]  # one row dealt twice, one dropped
    bad, jbad = dataclasses.replace(shards, order=order), dataclasses.replace(jshards, order=order)
    assert "plan.shard-roundtrip" in _codes(verify_shards(bad))
    assert _codes(verify_shards(bad)) == _codes(jverify_shards(jbad))
    assert "grid.shard-coverage" in _codes(check_sharded(bad, nb=2))
    assert _codes(check_sharded(bad, nb=2)) == _codes(jcheck_sharded(jbad, nb=2))


def test_sharded_mutant_divergent_replica():
    jplan, plan, _ = _mask_plans(7)
    shards, jshards = shard_plan(plan, 2, axis="N"), jshard_plan(jplan, 2, axis="N")
    nnz, idx = np.asarray(shards.nnz).copy(), np.asarray(shards.idx).copy()
    r = int(np.argmax(nnz[0] == 0)) if (nnz[0] == 0).any() else 0
    nnz[0, r] = 1
    idx[0, r, :] = 0
    rs, wr, wk = tplan_edit._workqueue_np(nnz[0], idx[0])
    fields = {}
    for name, new in (("row_starts", rs), ("work_row", wr), ("work_kblk", wk)):
        fields[name] = np.asarray(getattr(shards, name)).copy()
        fields[name][0] = new
    bad = dataclasses.replace(shards, nnz=nnz, idx=idx, **fields)
    jbad = dataclasses.replace(jshards, nnz=nnz, idx=idx, **fields)
    assert check_grid(nnz[0], idx[0], workqueue=(rs, wr, wk)) == []
    assert "grid.shard-coverage" in _codes(check_sharded(bad, nb=2))
    assert [(x.code, x.where) for x in check_sharded(bad, nb=2)] == \
        [(x.code, x.where) for x in jcheck_sharded(jbad, nb=2)]


@pytest.mark.parametrize("mode", list(tfaults.PLAN_CORRUPTIONS))
def test_a_corrupt_shard_is_found_in_both(mode):
    jplan, plan, _ = _mask_plans(9)
    shards, jshards = shard_plan(plan, 4, axis="M"), jshard_plan(jplan, 4, axis="M")
    nnz, idx = np.asarray(shards.nnz).copy(), np.asarray(shards.idx).copy()
    rs = np.asarray(shards.row_starts).copy()
    if mode == "nnz-range":
        nnz[1, 0] = idx.shape[-1] + 1
    elif mode == "idx-oob":
        nnz[1, 0] = max(int(nnz[1, 0]), 1)
        idx[1, 0, 0] = idx.shape[-1]
    else:
        rs[1, -1] += 1
    bad = dataclasses.replace(shards, nnz=nnz, idx=idx, row_starts=rs)
    jbad = dataclasses.replace(jshards, nnz=nnz, idx=idx, row_starts=rs)
    f, jf = verify_shards(bad), jverify_shards(jbad)
    assert f and [(x.code, x.where) for x in f] == [(x.code, x.where) for x in jf]
    assert _codes(check_sharded(bad)) == _codes(jcheck_sharded(jbad))
