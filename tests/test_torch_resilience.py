"""repro_torch.resilience (and the resilience of the checkpoint manager and
the dynamic-sparsity controller) against repro.resilience, on the CPU.

The port's counterparts of ``tests/test_resilience.py``'s fault-plan,
injector, log, checkpoint and controller cases, plus parity: one plan
string and seed fire the same ``(kind, tick)`` sequence and draw the same
corruptions in both packages, and ``corrupt_plan`` corrupts the port's
plan (device tensors) exactly as the JAX package corrupts its own.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import resilience as jres
from repro.runtime import plan_operand as jplan_operand
from repro_torch.analysis.plan_check import PlanVerificationError, check_plan
from repro_torch.checkpoint.manager import restore_latest, save
from repro_torch.resilience import (
    DB_CORRUPTIONS,
    KINDS,
    PLAN_CORRUPTIONS,
    FaultPlan,
    ResilienceLog,
    SimulatedAllocFailure,
    capture_warnings,
    corrupt_cache_entry,
    corrupt_db_file,
    corrupt_file,
    corrupt_plan,
    poison_slots,
    train_poison,
)
from repro_torch.resilience import faults as rfaults
from repro_torch.resilience import log as rlog
from repro_torch.runtime import PlanCache, Runtime, plan_operand


def _sparse_operand(rng, m=64, k=64, bm=8, bk=8, density=0.4):
    a = rng.normal(size=(m, k)).astype(np.float32)
    keep = rng.random((m // bm, k // bk)) < density
    a *= np.kron(keep, np.ones((bm, bk), np.float32))
    return a


def _arrays(plan):
    return [np.asarray(torch.as_tensor(x)) for x in (plan.nnz, plan.idx, *plan.workqueue())]


# ---------------------------------------------------------------------------
# FaultPlan: grammar, ticks, replay parity with the JAX package
# ---------------------------------------------------------------------------


def test_fault_plan_parse_grammar():
    fp = FaultPlan.parse(
        "nan_logits@2:slot=1,count=3; alloc_fail@0:where=grow_caches;"
        "step_stall@4:secs=0.25", seed=7,
    )
    assert len(fp.specs) == 3 and fp.seed == 7 and bool(fp)
    s0 = fp.specs[0]
    assert (s0.kind, s0.at, s0.slot, s0.count) == ("nan_logits", 2, 1, 3)
    assert s0.fires_at(2) and s0.fires_at(4) and not s0.fires_at(5)
    assert fp.specs[1].where == "grow_caches"
    assert fp.specs[2].secs == 0.25
    assert not FaultPlan.parse("") and not FaultPlan.parse(None)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("frobnicate@0")
    with pytest.raises(ValueError, match="unknown fault field"):
        FaultPlan.parse("nan_loss@0:wibble=3")


def test_fault_plan_ticks_where_and_reset():
    fp = FaultPlan.parse("shard_fail@1")
    assert [fp.tick("s") for _ in range(3)] == [0, 1, 2]
    assert fp.tick("other") == 0  # per-site counters
    assert not fp.fires("shard_fail", 0) and fp.fires("shard_fail", 1)
    fp.reset()
    assert fp.tick("s") == 0
    fa = FaultPlan.parse("alloc_fail@0:where=slot_caches")
    assert fa.fires("alloc_fail", 0, where="slot_caches")
    assert not fa.fires("alloc_fail", 0, where="grow_caches")
    with pytest.raises(SimulatedAllocFailure):
        rfaults.maybe_alloc_failure(fa, "slot_caches")
    rfaults.maybe_alloc_failure(fa, "grow_caches")  # filtered: no raise


@pytest.mark.parametrize("spec,seed", [
    ("nan_loss@3;step_stall@5:secs=1", 0),
    ("nan_loss@1:count=3", 4),
    ("nan_grad@2;preempt@6;nan_loss@2", 11),
    ("nan_logits@0:slot=1,count=2;inf_logits@3;alloc_fail@1:where=grow_caches", 7),
    ("plan_corrupt@0:mode=idx-oob;cache_corrupt@2;db_corrupt@1:mode=truncate", 3),
])
def test_fault_plan_fires_like_jax(spec, seed):
    """The same (kind, tick) firings, the same ticks and the same seeded
    draws in both packages for one plan string and seed."""
    t, j = FaultPlan.parse(spec, seed=seed), jres.FaultPlan.parse(spec, seed=seed)
    assert [s.__dict__ for s in t.specs] == [s.__dict__ for s in j.specs]
    fired = lambda p: [(k, i, w) for k in sorted(KINDS) for i in range(10)
                       for w in ("", "grow_caches") if p.fires(k, i, where=w)]
    assert fired(t) == fired(j) and fired(t)
    assert [train_poison(t, i) for i in range(8)] == [jres.train_poison(j, i) for i in range(8)]
    for i in range(5):
        np.testing.assert_array_equal(poison_slots(t, i, 4), jres.poison_slots(j, i, 4))
    assert [t.tick("x") for _ in range(4)] == [j.tick("x") for _ in range(4)]
    np.testing.assert_array_equal(t.rng.integers(0, 1000, 16), j.rng.integers(0, 1000, 16))


def test_poison_codes():
    fp = FaultPlan.parse("nan_logits@1:slot=2;inf_logits@3")
    assert poison_slots(fp, 0, 4).tolist() == [0, 0, 0, 0]
    assert poison_slots(fp, 1, 4).tolist() == [0, 0, 1, 0]
    assert poison_slots(fp, 3, 4).tolist() == [2, 2, 2, 2]  # slot=-1: all
    assert poison_slots(None, 1, 4).tolist() == [0, 0, 0, 0]
    tp = FaultPlan.parse("nan_loss@1;nan_grad@2")
    assert [train_poison(tp, i) for i in range(3)] == [0, 1, 2]
    assert train_poison(None, 1) == 0


def test_stall_sleeps_per_matching_spec():
    fp = FaultPlan.parse("step_stall@1:secs=0.01;step_stall@1:secs=0.02")
    assert rfaults.stall(fp, "step_stall", 0) == 0.0
    assert rfaults.stall(fp, "step_stall", 1) == pytest.approx(0.03)
    assert rfaults.stall(None, "step_stall", 1) == 0.0


# ---------------------------------------------------------------------------
# injectors stay honest on the port's objects
# ---------------------------------------------------------------------------


def test_seeded_corruption_replays_bit_identical():
    plan = plan_operand(torch.from_numpy(_sparse_operand(np.random.default_rng(3))), 8, 8)
    a = corrupt_plan(plan, rng=np.random.default_rng(11))
    b = corrupt_plan(plan, rng=np.random.default_rng(11))
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", PLAN_CORRUPTIONS)
def test_corrupt_plan_modes_fail_verification(mode):
    plan = plan_operand(torch.from_numpy(_sparse_operand(np.random.default_rng(0))), 8, 8)
    before = _arrays(plan)
    check_plan(plan, level="full")  # clean plan passes
    bad = corrupt_plan(plan, mode=mode)
    assert isinstance(bad.idx, torch.Tensor) and bad.idx.device == plan.idx.device
    with pytest.raises(PlanVerificationError):
        check_plan(bad, level="full")
    if mode in ("nnz-range", "row-starts"):  # O(Rb) structure faults:
        with pytest.raises(PlanVerificationError):  # the cheap tier sees them
            check_plan(bad, level="boundary")
    for x, y in zip(before, _arrays(plan)):  # the input plan is untouched
        np.testing.assert_array_equal(x, y)
    check_plan(plan, level="full")


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_corrupt_plan_equals_jax(seed):
    """Same plan, same seeded RNG: the same mode drawn and the same arrays."""
    a = _sparse_operand(np.random.default_rng(20 + seed))
    got = corrupt_plan(plan_operand(torch.from_numpy(a), 8, 8), rng=np.random.default_rng(seed))
    want = jres.corrupt_plan(jplan_operand(jnp.asarray(a), 8, 8), rng=np.random.default_rng(seed))
    for x, y in zip(_arrays(got), [np.asarray(v) for v in (want.nnz, want.idx, *want.workqueue())]):
        np.testing.assert_array_equal(x, y)


def test_corrupt_cache_entry_keeps_source_and_version():
    rng = np.random.default_rng(9)
    cache = PlanCache()
    assert corrupt_cache_entry(cache, rng=rng) is None  # empty: nothing to corrupt
    srcs = {}
    for seed in (1, 2):
        a = torch.from_numpy(_sparse_operand(np.random.default_rng(seed)))
        plan = plan_operand(a, 8, 8)
        srcs[seed] = plan.idx
        cache.store(("w", seed), plan.idx, plan)
    key = corrupt_cache_entry(cache, rng=rng, mode="row-starts")
    assert key[0] in (("w", 1), ("w", 2))
    bad = cache.lookup(key[0], srcs[key[0][1]], 8, 8)
    assert bad is not None  # source and version kept: a lookup hits the corrupt plan
    with pytest.raises(PlanVerificationError):
        check_plan(bad, level="boundary")


@pytest.mark.parametrize("mode", DB_CORRUPTIONS)
def test_tuning_db_corruption_degrades_to_empty(mode, tmp_path):
    from repro_torch.tune.db import TunedPolicy, TuningDB

    path = tmp_path / "db.json"
    db = TuningDB(platform="cpu")
    db.store(db.key(op="matmul", m=64, k=256, n=64, dtype=torch.float32, density=0.5),
             TunedPolicy(bm=8, bk=16, bn=16))
    db.save(path)
    assert len(TuningDB.load(path, platform="cpu")) == 1  # round-trips clean
    assert corrupt_db_file(path, mode=mode) == mode
    with pytest.warns(UserWarning, match="TuningDB"):
        db2 = TuningDB.load(path, platform="cpu")
    assert len(db2) == 0  # never serves corrupt policies


def test_corrupt_file_replays_and_keeps_length(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    for p in (a, b):
        p.write_bytes(bytes(range(40)))
        corrupt_file(p, rng=np.random.default_rng(5))
    assert a.read_bytes() == b.read_bytes() != bytes(range(40)) and len(a.read_bytes()) == 40
    c = tmp_path / "c.bin"
    c.write_bytes(bytes(range(40)))
    jres.corrupt_file(c, rng=np.random.default_rng(5))
    assert c.read_bytes() == a.read_bytes()


# ---------------------------------------------------------------------------
# ResilienceLog
# ---------------------------------------------------------------------------


def test_resilience_log_counts_and_summary():
    log = ResilienceLog()
    assert len(log) == 0 and log.summary() == "resilience: no degradation events"
    log.record("nonfinite", "train.step", "skip-step", step=3)
    log.record("nonfinite", "train.step", "skip-step", step=4)
    log.record("deadline", "train.step", "checkpoint-abort", step=5)
    assert len(log) == 3
    assert log.counts()[("nonfinite", "skip-step")] == 2
    assert len(log.by_kind("deadline")) == 1
    assert "nonfinite -> skip-step x2  [train.step]" in log.summary()
    assert '"step": 3' in log.to_json()
    jlog = jres.ResilienceLog()
    for e in log.events:
        jlog.record(e.kind, e.site, e.action, **e.detail)
    assert jlog.summary() == log.summary()


def test_ambient_log_and_module_record():
    assert rlog.record("x", "y", "z") is None  # no-op without a log
    log = ResilienceLog()
    with rlog.use_log(log):
        assert rlog.ambient_log() is log
        rlog.record("checkpoint", "site", "skip-corrupt")
    assert rlog.ambient_log() is None
    assert len(log) == 1 and log.events[0].kind == "checkpoint"


def test_capture_warnings_mirrors_into_log():
    log = ResilienceLog()
    with pytest.warns(RuntimeWarning, match="hello"):  # still emitted
        with capture_warnings(log):
            warnings.warn("hello degradation", RuntimeWarning)
    assert len(log) == 1 and log.events[0].detail["category"] == "RuntimeWarning"


# ---------------------------------------------------------------------------
# checkpoint: corrupt-on-disk -> restore_latest walks back
# ---------------------------------------------------------------------------


def test_restore_latest_skips_corrupt_checkpoint(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    save(tmp_path, 1, tree)
    save(tmp_path, 2, {"w": tree["w"] + 1})
    corrupt_file(os.path.join(tmp_path, "step_000000000002", "arrays.npz"))
    log = ResilienceLog()
    with rlog.use_log(log):
        with pytest.warns(RuntimeWarning, match="unreadable"):
            step, got = restore_latest(tmp_path, tree)
    assert step == 1 and got["w"].tolist() == list(range(6))
    ev = log.by_kind("checkpoint")
    assert ev and ev[0].action == "skip-corrupt" and ev[0].detail["step"] == 2


def test_restore_latest_empty_and_all_corrupt(tmp_path):
    tree = {"w": torch.zeros(3)}
    assert restore_latest(tmp_path / "nope", tree) == (None, None)
    save(tmp_path, 1, tree)
    corrupt_file(os.path.join(tmp_path, "step_000000000001", "arrays.npz"))
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert restore_latest(tmp_path, tree) == (None, None)


# ---------------------------------------------------------------------------
# dynamic sparse training: corrupt live plan -> loud from-scratch replan
# ---------------------------------------------------------------------------


def _make_controller(validate: str = "off"):
    from repro_torch.sparse_train import DynamicSparsityConfig, DynamicSparsityController

    rng = np.random.default_rng(12)
    rt = Runtime(backend="dense", device="cpu", bm=8, bk=16, bn=16, validate=validate)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))}
    cfg = DynamicSparsityConfig(target=0.75, begin=0, end=6, update_every=1, min_size=256)
    ctrl = DynamicSparsityController(cfg, params, rt=rt)
    return ctrl, params, rng


def test_controller_degrades_to_from_scratch_replan(monkeypatch):
    import repro_torch.sparse_train.controller as ctrl_mod
    from repro_torch.sparse_train import apply_block_masks, block_scores, plan_from_block_mask

    clean_ctrl, params, rng = _make_controller("boundary")
    bad_ctrl, _, _ = _make_controller("boundary")
    (path,) = clean_ctrl.units
    spec = clean_ctrl.spec()
    scores = block_scores(apply_block_masks({"w": params["w"].clone()}, clean_ctrl.masks(), spec), spec)
    gs = {path: rng.random((4, 3)).astype(np.float32)}
    u = bad_ctrl.units[path]

    def broken_edit(plan, delta, **kw):
        raise ValueError("injected: spliced queue failed verification")

    log = ResilienceLog()
    with rlog.use_log(log), monkeypatch.context() as mp:
        mp.setattr(ctrl_mod, "edit_plan", broken_edit)
        with pytest.warns(RuntimeWarning, match="from-scratch replan"):
            rep_bad = bad_ctrl.update(1, scores, gs)
    rep_clean = clean_ctrl.update(1, scores, gs)
    assert rep_bad["pruned"] == rep_clean["pruned"] > 0
    ev = log.by_kind("plan-corrupt")
    assert ev and ev[0].action == "replan"
    cu = clean_ctrl.units[path]
    np.testing.assert_array_equal(u.mask, cu.mask)
    bk, bn = u.block
    want = plan_from_block_mask(u.mask[0], bm=bk, bk=bn, shape=(u.kb * bk, u.nb * bn),
                                dtype=u.bwd[0].dtype)
    for x, y in zip(_arrays(u.bwd[0]), _arrays(want)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(_arrays(u.bwd[0]), _arrays(cu.bwd[0])):  # the splice agrees too
        np.testing.assert_array_equal(x, y)
    scores2 = block_scores(apply_block_masks({"w": params["w"].clone()}, bad_ctrl.masks(), spec), spec)
    bad_ctrl.update(2, scores2, gs)  # the recovered controller keeps ramping


def test_controller_replans_a_corrupted_live_plan():
    """A corrupt live plan (``corrupt_plan``: a work-queue entry off the
    schedule) fails the edit's structural check under the runtime's
    ``validate="full"`` and both plans of the layer are replanned from the
    mask."""
    ctrl, params, rng = _make_controller("full")
    (path,) = ctrl.units
    u = ctrl.units[path]
    u.fwd[0] = corrupt_plan(u.fwd[0], mode="queue-entry")
    scores = {path: rng.random((4, 3)).astype(np.float32)}
    log = ResilienceLog()
    with rlog.use_log(log), pytest.warns(RuntimeWarning, match="from-scratch replan"):
        ctrl.update(1, scores, scores)
    assert log.counts()[("plan-corrupt", "replan")] == 1
    check_plan(u.bwd[0], level="full")
    check_plan(u.fwd[0], level="full")


def test_controller_drift_is_a_bug_not_a_degradation():
    from repro_torch.sparse_train import PlanDelta
    from repro_torch.sparse_train.controller import DynamicSparsityController

    mask = np.ones((4, 3), bool)
    mask[0, 0] = False
    ok = DynamicSparsityController._delta_consistent
    assert ok(mask, PlanDelta.make([[1, 1]], [[0, 0]]))
    assert not ok(mask, PlanDelta.make([[0, 0]], []))  # prune inactive
    assert not ok(mask, PlanDelta.make([], [[1, 1]]))  # regrow active
