"""repro_torch.sparse_train and repro_torch.optim.sparsify against the JAX
package, on the CPU.

* Plan edits: ``edit_plan`` equals, bit for bit, ``plan_from_block_mask``
  of the edited mask, the port's ``plan_blocks_csr`` of an operand with
  that block map and the JAX package's ``edit_plan`` of the same delta
  (prune-only, regrow-only, mixed, dense; both edit paths; repeated edits;
  all-zero rows), on the plan's device with its host arrays kept.
* Masks: the stacked JAX paths of the port's per-layer trees, the mask
  utilities and ``apply_block_masks`` against JAX's on stacked trees.
* The controller: ``_select`` on the same numpy scores gives the same
  deltas exactly; the ramp lands on the block budget, plans stay the
  mask's transpose pair and refresh their cache entries.
* Dynamic sparse training end to end: 10 steps of
  ``make_train_step(dynamic_sparsity=)`` on ``reduce_config(qwen3-4b)`` and
  the ReLU language model, parameters carried across by ``params_from_jax``,
  fp32, ``dense`` and ``reference`` backends at ``bm=8, bk=16, bn=16``:
  masks equal to JAX's after every refresh, losses and ``dst_density``
  within rtol = atol = 1e-5; pruned blocks stay exactly zero through AdamW.
* ``optim.sparsify``: the float32 ramp exactly, the kept count and mask on
  ties exactly, ``pact``/``meprop`` forward and gradients against JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro import sparse_train as jst
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.optim import sparsify as jsparsify
from repro.train import step as jstep
from repro_torch import runtime as trt
from repro_torch import sparse_train as tst
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.kernels.tensordash_spmm import plan_blocks_csr, plan_to_mask
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import sparsify as tsparsify
from repro_torch.sparse_train.plan_edit import _SPLICE_MAX_ROW_FRACTION
from repro_torch.train import step as tstep

GEOM = dict(bm=8, bk=16, bn=16)
DST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(plan):
    return [np.asarray(torch.as_tensor(x)) for x in (plan.nnz, plan.idx, *plan.workqueue())]


def _replan(mask, bm, bk):
    """The port's ``plan_blocks_csr`` of an operand whose block map is ``mask``."""
    mb, kb = mask.shape
    vals = torch.from_numpy(np.kron(mask, np.ones((bm, bk))).astype(np.float32))
    return [x.numpy() for x in plan_blocks_csr(vals, bm, bk)]


def _assert_plan_equals(plan, want):
    for name, a, b in zip(["nnz", "idx", "row_starts", "work_row", "work_kblk"], _arrays(plan), want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _random_delta(rng, mask, n_prune, n_regrow):
    act, inact = np.stack(np.nonzero(mask), 1), np.stack(np.nonzero(~mask), 1)
    p = act[rng.choice(len(act), min(n_prune, len(act)), replace=False)] if len(act) and n_prune else np.empty((0, 2))
    g = (inact[rng.choice(len(inact), min(n_regrow, len(inact)), replace=False)]
         if len(inact) and n_regrow else np.empty((0, 2)))
    return p, g


# ---------------------------------------------------------------------------
# plan edits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb,kb,dens", [(8, 8, 0.5), (16, 32, 0.1), (32, 16, 0.9), (8, 8, 0.0), (1, 5, 0.6)])
def test_plan_from_block_mask_equals_replans_and_jax(mb, kb, dens):
    mask = np.random.default_rng(mb * kb).random((mb, kb)) < dens
    plan = tst.plan_from_block_mask(mask, bm=4, bk=4, shape=(mb * 4, kb * 4), dtype=torch.float32)
    _assert_plan_equals(plan, _replan(mask, 4, 4))
    j = jst.plan_from_block_mask(mask, bm=4, bk=4, shape=(mb * 4, kb * 4), dtype=jnp.float32)
    _assert_plan_equals(plan, [j.nnz, j.idx, j.row_starts, j.work_row, j.work_kblk])
    np.testing.assert_array_equal(plan_to_mask(plan.nnz, plan.idx).numpy(), mask)
    assert plan.density() == pytest.approx(mask.mean())


@pytest.mark.parametrize("n_prune,n_regrow", [(6, 0), (0, 6), (6, 6), (64, 64)],
                         ids=["prune_only", "regrow_only", "mixed_small", "mixed_dense"])
def test_edit_plan_bit_identical_to_replan_and_jax(n_prune, n_regrow):
    """A spliced (or entry-merged) edit equals a from-scratch replan of the
    edited mask and the JAX package's edit of the same delta, bit for bit,
    over repeated edits (each output is the next input)."""
    rng = np.random.default_rng(1 + n_prune * 7 + n_regrow)
    for dens in (0.1, 0.5, 0.9):
        mask = rng.random((32, 32)) < dens
        plan = tst.plan_from_block_mask(mask, bm=4, bk=4, shape=(128, 128), dtype=torch.float32)
        jplan = jst.plan_from_block_mask(mask, bm=4, bk=4, shape=(128, 128), dtype=jnp.float32)
        for _ in range(3):
            p, g = _random_delta(rng, mask, n_prune, n_regrow)
            plan = tst.edit_plan(plan, tst.PlanDelta.make(p, g))
            jplan = jst.edit_plan(jplan, jst.PlanDelta.make(p, g))
            mask = tst.apply_delta(mask, tst.PlanDelta.make(p, g))
            _assert_plan_equals(plan, _replan(mask, 4, 4))
            _assert_plan_equals(plan, [jplan.nnz, jplan.idx, jplan.row_starts, jplan.work_row,
                                       jplan.work_kblk])
            assert isinstance(plan.idx, torch.Tensor) and plan.idx.device.type == "cpu"
            assert plan.effectual_blocks() == int(mask.sum())


def test_edit_plan_covers_both_paths_and_all_zero_rows():
    rng = np.random.default_rng(2)
    mask = rng.random((32, 32)) < 0.5
    plan = tst.plan_from_block_mask(mask, bm=4, bk=4, shape=(128, 128), dtype=torch.float32)
    for n, splice in ((2, True), (100, False)):
        p, g = _random_delta(rng, mask, n, n)
        rows = len(np.unique(np.concatenate([np.asarray(p)[:, 0], np.asarray(g)[:, 0]])))
        assert (rows <= _SPLICE_MAX_ROW_FRACTION * 32) == splice
        d = tst.PlanDelta.make(p, g)
        _assert_plan_equals(tst.edit_plan(plan, d), _replan(tst.apply_delta(mask, d), 4, 4))
    mask = np.zeros((8, 8), bool)
    mask[3, [1, 4]] = True
    mask[5, 2] = True
    plan = tst.plan_from_block_mask(mask, bm=4, bk=4, shape=(32, 32), dtype=torch.float32)
    for d in (tst.PlanDelta.make([[5, 2]], []), tst.PlanDelta.make([], [[5, 0], [5, 7], [0, 3]])):
        plan, mask = tst.edit_plan(plan, d), tst.apply_delta(mask, d)
        _assert_plan_equals(plan, _replan(mask, 4, 4))
    plan = tst.edit_plan(plan, tst.PlanDelta.make(np.stack(np.nonzero(mask), 1), []))
    _assert_plan_equals(plan, _replan(np.zeros_like(mask), 4, 4))


def test_edit_plan_validation_errors():
    rng = np.random.default_rng(3)
    mask = rng.random((16, 16)) < 0.5
    plan = tst.plan_from_block_mask(mask, bm=4, bk=4, shape=(64, 64), dtype=torch.float32)
    inact, act = np.stack(np.nonzero(~mask), 1), np.stack(np.nonzero(mask), 1)
    for delta, msg in [((inact[:1], []), "prune of inactive"), (([], act[:1]), "regrow of active"),
                       (([[16, 0]], []), "row out of range"), (([], [[0, 16]]), "k-block out of range"),
                       ((np.concatenate([act[:40], inact[:1]]), []), "prune of inactive"),
                       ((act[:40], act[:1]), "same block")]:
        with pytest.raises(ValueError, match=msg):
            tst.edit_plan(plan, tst.PlanDelta.make(*delta))
    assert tst.edit_plan(plan, tst.PlanDelta.make([], [])) is plan
    tst.edit_plan(plan, tst.PlanDelta.make(act[:1], []), validate="full")  # the verifier passes it


# ---------------------------------------------------------------------------
# masks on the port's per-layer trees, keyed by the JAX paths
# ---------------------------------------------------------------------------


def _jax_and_port_params(jcfg, tcfg, seed=0, dtype=jnp.float32):
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=dtype)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


def _qwen_cfgs(**kw):
    j = dataclasses.replace(jreduce_config(jget_config("qwen3-4b")), **kw)
    t = dataclasses.replace(reduce_config(get_config("qwen3-4b")), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _relu_cfgs():
    j = dataclasses.replace(jreduce_config(jget_config("deepseek-7b")), activation="relu")
    t = dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")
    return j, t


@pytest.mark.parametrize("layers", [2, 8])
def test_stacked_paths_and_maskable_equal_jax(layers):
    """At 8 layers JAX's stacked ``[L, d]`` norm gains are 2-D leaves big
    enough to mask; the port keys and masks them the same way."""
    jcfg, tcfg = _qwen_cfgs(num_layers=layers)
    jp, tp = _jax_and_port_params(jcfg, tcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    jshapes = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}
    got = tst.stacked_leaves(tp)
    assert list(got) == list(jshapes) and {k: v.shape for k, v in got.items()} == jshapes
    assert list(tst.mask_paths(tp, exclude=("embed",))) == list(jst.mask_paths(jp, exclude=("embed",)))
    assert ("['layers']['ln1']" in tst.mask_paths(tp)) == (layers == 8)


def test_block_utilities_and_apply_masks_equal_jax():
    jcfg, tcfg = _qwen_cfgs(num_layers=8)
    jp, tp = _jax_and_port_params(jcfg, tcfg)
    jr = jrt.Runtime(backend="dense", **GEOM)
    with jrt.use(jr):
        jctrl = jst.DynamicSparsityController(jst.DynamicSparsityConfig(target=0.5), jp)
    tctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(target=0.5), tp,
                                          rt=trt.Runtime(backend="dense", device="cpu", **GEOM))
    assert tctrl.spec() == jctrl.spec()
    spec = tctrl.spec()
    rng = np.random.default_rng(7)
    masks = {p: rng.random(np.asarray(m).shape) < 0.6 for p, m in jctrl.masks().items()}
    jm = jst.apply_block_masks(jp, {p: jnp.asarray(m) for p, m in masks.items()}, spec)
    tm = tst.apply_block_masks(tp, {p: torch.from_numpy(m) for p, m in masks.items()}, spec)
    assert tm is tp  # in place
    for p, leaf in tst.stacked_leaves(tp).items():
        jleaf = np.asarray(jm[p[2:-2]] if p.count("[") == 1 else _at(jm, p))
        np.testing.assert_array_equal(np.stack([x.numpy() for x in leaf.leaves]) if leaf.stacked
                                      else leaf.leaves[0].numpy(), jleaf)
    js, ts = jst.block_scores(jm, spec), tst.block_scores(tp, spec)
    assert list(ts) == list(js)
    for p in spec:
        np.testing.assert_allclose(ts[p].numpy(), np.asarray(js[p]), rtol=1e-5, atol=1e-6)
        em = tst.expand_block_mask(torch.from_numpy(masks[p]), spec[p]).numpy()
        np.testing.assert_array_equal(em, np.asarray(jst.expand_block_mask(jnp.asarray(masks[p]), spec[p])))
    tmasks = {p: torch.from_numpy(m) for p, m in masks.items()}
    jmasks = {p: jnp.asarray(m) for p, m in masks.items()}
    assert float(tst.mask_density(tmasks, spec)) == float(jst.mask_density(jmasks, spec))


def _at(tree, path):
    for k in path[2:-2].split("']['"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_select_deltas_equal_jax_on_the_same_scores(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((12, 9)) < [0.3, 0.7, 1.0, 0.95][seed]
    ws = rng.random((12, 9)).astype(np.float32)
    gs = rng.random((12, 9)).astype(np.float32)
    ws[:, :2] = 0.5  # ties
    for s_target, frac in ((0.2, 0.3), (0.5, 0.1), (0.75, 0.0), (0.9, 0.25)):
        t = tst.DynamicSparsityController._select(mask, ws, gs, s_target, frac)
        j = jst.DynamicSparsityController._select(mask, ws, gs, s_target, frac)
        np.testing.assert_array_equal(t.prune, j.prune)
        np.testing.assert_array_equal(t.regrow, j.regrow)


def test_controller_ramp_plans_and_cache():
    rng = np.random.default_rng(5)
    rt = trt.Runtime(backend="dense", device="cpu", **GEOM)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))}
    cfg = tst.DynamicSparsityConfig(target=0.75, begin=0, end=6, update_every=1, alpha=0.3, min_size=256)
    ctrl = tst.DynamicSparsityController(cfg, params, rt=rt)
    (path,) = ctrl.units
    assert path == "['w']" and ctrl.density() == 1.0 and rt.plan_cache.stats()["entries"] == 2
    for step in range(6):
        assert ctrl.should_update(step)
        tst.apply_block_masks(params, ctrl.masks(), ctrl.spec())
        rep = ctrl.update(step, tst.block_scores(params, ctrl.spec()), {path: rng.random((4, 3))})
        b = ctrl.units[path].mask[0].size
        desired = max(int(round((1.0 - cfg.sparsity_at(step)) * b)), 1)
        assert int(ctrl.units[path].mask.sum()) == desired and rep["edit_ms"] >= 0.0
        fwd, bwd = ctrl.plans(path)
        np.testing.assert_array_equal(plan_to_mask(fwd.nnz, fwd.idx).numpy(), ctrl.units[path].mask[0].T)
        np.testing.assert_array_equal(plan_to_mask(bwd.nnz, bwd.idx).numpy(), ctrl.units[path].mask[0])
        assert rt.plan_cache.stats()["entries"] == 2  # refreshed, never duplicated
        assert rt.plan_cache.lookup(("dst", path, 0, "fwd"), fwd.idx, fwd.bm, fwd.bk, side="B") is fwd
    assert not ctrl.should_update(6) and abs(ctrl.sparsity() - 0.75) < 0.05
    full = tst.DynamicSparsityController(tst.DynamicSparsityConfig(target=0.0, end=4, update_every=1),
                                         params, rt=rt)
    for step in range(4):
        full.update(step, tst.block_scores(params, full.spec()))
        assert full.density() == 1.0
    with pytest.raises(ValueError, match="no maskable weights"):
        tst.DynamicSparsityController(tst.DynamicSparsityConfig(min_size=10**9), params, rt=rt)


def test_dynamic_step_requires_masks():
    _, tcfg = _qwen_cfgs()
    step = tstep.make_train_step(tcfg, tadamw.OptConfig(), dynamic_sparsity={"x": (8, 8)})
    with pytest.raises(TypeError, match="masks"):
        step({}, None, {"tokens": torch.zeros((2, 4), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# dynamic sparse training against the JAX package
# ---------------------------------------------------------------------------


def _check_zero_blocks(params, ctrl):
    """Stored params carry exactly-zero blocks wherever the mask is off."""
    leaves = tst.stacked_leaves(params)
    checked = 0
    for path, u in ctrl.units.items():
        lf = leaves[path]
        x = torch.stack(lf.leaves) if lf.stacked else lf.leaves[0]
        blk = tst.block_abs_sum(x.detach(), u.block).reshape(u.mask.shape).numpy()
        assert (blk[~u.mask] == 0.0).all(), path
        checked += int((~u.mask).sum())
    return checked


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("model", ["qwen3-4b", "relu-lm"])
def test_dynamic_sparse_training_equals_jax(model, backend):
    jcfg, tcfg = _qwen_cfgs() if model == "qwen3-4b" else _relu_cfgs()
    jp, tp = _jax_and_port_params(jcfg, tcfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=40, weight_decay=0.0)
    dcfg = dict(target=0.5, begin=0, end=8, update_every=2)
    jdata = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=7)
    tdata = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=7)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jctrl = jst.DynamicSparsityController(jst.DynamicSparsityConfig(**dcfg), jp)
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**ocfg), dynamic_sparsity=jctrl))
    with tr.use():
        tctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(**dcfg), tp)
        tfn = tstep.make_train_step(tcfg, tadamw.OptConfig(**ocfg), dynamic_sparsity=tctrl)
    assert list(tctrl.units) == list(jctrl.units) and tctrl.spec() == jctrl.spec()
    jopt, topt = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jmasks, tmasks = jctrl.masks(), tctrl.masks()
    refreshes = 0
    for i in range(10):
        with jrt.use(jr):
            jp, jopt, jm = jfn(jp, jopt, jdata.batch_at(i), jmasks)
        with tr.use():
            tp, topt, tm = tfn(tp, topt, tdata.batch_at(i, device="cpu"), tmasks)
        jm = jax.device_get(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **DST_TOL)
        np.testing.assert_allclose(float(tm["dst_density"]), float(jm["dst_density"]), **DST_TOL)
        assert list(tm["dst_w_scores"]) == list(jm["dst_w_scores"])
        if jctrl.should_update(i):
            assert tctrl.should_update(i)
            with jrt.use(jr):
                jrep = jctrl.update(i, jm["dst_w_scores"], jm["dst_g_scores"])
            trep = tctrl.update(i, tm["dst_w_scores"], tm["dst_g_scores"])
            for p in jctrl.units:
                np.testing.assert_array_equal(tctrl.units[p].mask, jctrl.units[p].mask, err_msg=p)
            assert (trep["pruned"], trep["regrown"], trep["sparsity"]) == (
                jrep["pruned"], jrep["regrown"], jrep["sparsity"])
            jmasks, tmasks = jctrl.masks(), tctrl.masks()
            refreshes += 1
    assert refreshes == 4 and 0.4 < tctrl.sparsity() <= 0.6 and float(tm["dst_density"]) < 1.0
    assert _check_zero_blocks(tp, tctrl) > 0


def _off_mask_mass(params, ctrl):
    """Blocks outside the controller's masks that are not zero."""
    leaves = tst.stacked_leaves(params)
    n = 0
    for path, u in ctrl.units.items():
        lf = leaves[path]
        x = torch.stack(lf.leaves) if lf.stacked else lf.leaves[0]
        blk = tst.block_abs_sum(x.detach(), u.block).reshape(u.mask.shape).numpy()
        n += int((blk[~u.mask] != 0.0).sum())
    return n


def test_skipped_step_after_refresh_equals_jax():
    """A NaN loss on the step right after a refresh is skipped and returns
    the step's input, as JAX's guarded step does: the blocks the new mask
    had just zeroed get their values back, and the run goes on equal to
    JAX's through the next refresh."""
    jcfg, tcfg = _qwen_cfgs()
    jp, tp = _jax_and_port_params(jcfg, tcfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=40, weight_decay=0.0)
    dcfg = dict(target=0.5, begin=0, end=6, update_every=2)
    jdata = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=7)
    tdata = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=7)
    jr = jrt.Runtime(backend="dense", **GEOM)
    tr = trt.Runtime(backend="dense", device="cpu", **GEOM)
    with jrt.use(jr):
        jctrl = jst.DynamicSparsityController(jst.DynamicSparsityConfig(**dcfg), jp)
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**ocfg), dynamic_sparsity=jctrl,
                                            guard_nonfinite=True))
    with tr.use():
        tctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(**dcfg), tp)
        tfn = tstep.make_train_step(tcfg, tadamw.OptConfig(**ocfg), dynamic_sparsity=tctrl,
                                    guard_nonfinite=True)
    jopt, topt = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jmasks, tmasks = jctrl.masks(), tctrl.masks()
    poison_at, skipped = None, 0
    for i in range(5):
        poison = int(i == poison_at)
        jbefore = jax.tree.map(np.asarray, jp)
        tbefore = [x.detach().clone() for leaf in tst.stacked_leaves(tp).values() for x in leaf.leaves]
        with jrt.use(jr):
            jp, jopt, jm = jfn(jp, jopt, jdata.batch_at(i), jmasks, poison)
        with tr.use():
            tp, topt, tm = tfn(tp, topt, tdata.batch_at(i, device="cpu"), tmasks, poison)
        jm = jax.device_get(jm)
        assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == poison
        np.testing.assert_allclose(float(tm["param_norm"]), float(jm["param_norm"]), **DST_TOL)
        if poison:
            # both return the step's input bit for bit: the just-pruned
            # blocks hold their old values again
            skipped = _off_mask_mass(tp, tctrl)
            after = [x for leaf in tst.stacked_leaves(tp).values() for x in leaf.leaves]
            assert all(torch.equal(a, b) for a, b in zip(after, tbefore))
            jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jp), jbefore)
            continue
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **DST_TOL)
        if jctrl.should_update(i):
            with jrt.use(jr):
                jrep = jctrl.update(i, jm["dst_w_scores"], jm["dst_g_scores"])
            trep = tctrl.update(i, tm["dst_w_scores"], tm["dst_g_scores"])
            for p in jctrl.units:
                np.testing.assert_array_equal(tctrl.units[p].mask, jctrl.units[p].mask, err_msg=p)
            if poison_at is None and trep["pruned"]:
                poison_at = i + 1
            assert trep["pruned"] == jrep["pruned"]
            jmasks, tmasks = jctrl.masks(), tctrl.masks()
    assert poison_at is not None and skipped > 0


def test_pruned_blocks_stay_zero_through_adamw():
    """Weight decay and stale Adam moments would move a pruned block off
    zero; the step's gradient and parameter masks keep it at exactly zero,
    step after step, and the LM-head plan replans the re-masked weight."""
    _, tcfg = _relu_cfgs()
    jp, tp = _jax_and_port_params(*_relu_cfgs())
    rt = trt.Runtime(backend="reference", device="cpu", **GEOM)
    data = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    with rt.use():
        ctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(target=0.5, end=2, update_every=1), tp)
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(lr=1e-2, warmup_steps=1, weight_decay=0.1),
                                   microbatches=2, dynamic_sparsity=ctrl)
        opt = tadamw.init_opt_state(tp)
        masks = ctrl.masks()
        for i in range(5):
            tp, opt, m = fn(tp, opt, data.batch_at(i, device="cpu"), masks)
            if ctrl.should_update(i):
                ctrl.update(i, m["dst_w_scores"], m["dst_g_scores"])
                masks = ctrl.masks()
            else:
                assert _check_zero_blocks(tp, ctrl) > 0
    # the LM head's value plan (built in the last step's forward) is the
    # controller's forward plan for the mask that step ran with
    (head,) = [p for k, (_, _, p) in rt.plan_cache._entries.items() if k[0][0] == "lm_head"]
    fwd, _ = ctrl.plans("['lm_head']")
    _assert_plan_equals(head, _arrays(fwd))
    assert head.skipped_fraction() > 0.0


# ---------------------------------------------------------------------------
# optim.sparsify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target,begin,end", [(0.5, 0, 8), (0.9, 2, 1000), (0.75, 0, 6), (0.5, 0, 6), (0.3, 5, 5)])
def test_prune_schedule_equals_jax(target, begin, end):
    for step in range(0, 14):
        assert float(tsparsify.prune_schedule(step, target, begin, end)) == float(
            jsparsify.prune_schedule(step, target, begin, end))


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.7, 0.99])
def test_refresh_masks_kept_count_and_ties_equal_jax(sparsity):
    rng = np.random.default_rng(11)
    tree = {"w": rng.integers(-3, 4, size=(16, 24)).astype(np.float32),  # heavy ties
            "v": rng.standard_normal((20, 20)).astype(np.float32),
            "b": rng.standard_normal((30,)).astype(np.float32)}
    jm = jsparsify.refresh_masks({k: jnp.asarray(v) for k, v in tree.items()}, sparsity).masks
    tm = tsparsify.refresh_masks({k: torch.from_numpy(v) for k, v in tree.items()}, sparsity).masks
    for k in tree:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    n = tree["w"].size
    assert int(tm["w"].sum()) == n - min(int(sparsity * n), n - 1)
    assert bool(tm["b"].all())  # 1-D leaves stay dense
    masked = tsparsify.apply_masks({k: torch.from_numpy(v) for k, v in tree.items()},
                                   tsparsify.PruneState(tm))
    np.testing.assert_array_equal(masked["w"].numpy(), tree["w"] * np.asarray(jm["w"]))
    assert all(bool(m.all()) for m in tsparsify.init_prune({"w": torch.zeros(2, 3)}).masks.values())


@pytest.mark.parametrize("bits,alpha", [(4, 1.0), (2, 0.5), (8, 2.0)])
def test_pact_forward_and_grads_equal_jax(bits, alpha):
    x = np.random.default_rng(bits).standard_normal((6, 10)).astype(np.float32)
    x[0, :4] = [0.0, alpha, -0.0, 2 * alpha]  # the clip's ties and both sides
    w = np.random.default_rng(1).standard_normal((6, 10)).astype(np.float32)
    jf = lambda x, a: jnp.sum(jsparsify.pact(x, a, bits) * w)
    jy = jsparsify.pact(jnp.asarray(x), jnp.float32(alpha), bits)
    jgx, jga = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.float32(alpha))
    tx = torch.from_numpy(x).requires_grad_(True)
    ta = torch.tensor(alpha, requires_grad=True)
    ty = tsparsify.pact(tx, ta, bits)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ta.grad), float(jga), rtol=1e-5, atol=1e-6)
    assert (ty.detach().numpy() == 0).any()  # sub-LSB values quantise to exact zeros


@pytest.mark.parametrize("k", [1, 3, 7])
def test_meprop_forward_and_grads_equal_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((4, 3, 5)).astype(np.float32)
    w = rng.standard_normal((4, 3, 5)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jsparsify.meprop(x, k) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tsparsify.meprop(tx, k)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), x)
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    assert ((tx.grad.numpy() != 0).reshape(4, -1).sum(1) == k).all()
