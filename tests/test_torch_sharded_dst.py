"""Dynamic sparse training on a mesh, on 4 CPU ranks, against the JAX
package's jitted dynamic-sparsity step on a mesh of the same shape.

One pool of 4 spawned ranks per module (``repro_torch.parallel.rehearsal``)
builds a ``(data, model)`` mesh per run; the JAX side runs in the test
process under ``jax.jit`` with ``Runtime(sharding=ShardingPolicy(mesh=Mesh(
devices[:4].reshape(shape), ("data", "model"))))`` (a ``Mesh(...)``
constructor: ``tests/conftest.py`` forces 8 host devices).

Each rank holds its ``local_shard`` of every parameter, builds the
controller from the global shapes (``specs=``) and runs 6 steps of
``make_train_step(dynamic_sparsity=ctrl, guard_nonfinite=True)`` with a
refresh every 2 steps (RigL to 50%, ``min_size`` 64 so the stacked norm
gains are controlled units too), on the ``reference`` backend at ``bm, bk,
bn = 8, 32, 32``.  Models: reduced deepseek-7b-ReLU with ``d_ff`` 96 and
vocab 192 on ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``, so the FFN and head
slices (48 or 24 columns a rank) and the FSDP rows (16 a rank over 4 data
ranks) cut through mask blocks; reduced qwen3-moe-ReLU (the experts over
``model``, their FFN dim over ``data``) and reduced mamba2 on ``(2, 2)``.

At every refresh: the units, ``spec()``, every mask and the report's
``pruned``/``regrown``/``sparsity`` equal JAX's, every rank holds the same
masks, and the scores are within rtol = atol = 1e-5 of JAX's, with the
margin between the last kept and the first dropped block wider than twice
the two packages' largest score difference in that layer (so equal masks
are not luck: the port's own scores must select those blocks).  Every step's loss and gradient
norm, the gradients at the masked point after the first refresh and the
parameters after the last step are within 1e-5.  A NaN-poisoned step right
after a refresh is skipped and returns the parameters it was given.  The
launcher's ``--dynamic-sparsity`` on a ``(2, 2)`` mesh prints the one-rank
run's refresh lines and ``Wdens``, from rank 0 alone.  Without a process
group: the units from a rank's slices are the global leaves', its masked
slices are the masked whole's, and its partial scores sum to the whole's
on every cut; a rank whose masks differ makes every rank's refresh raise;
``relu``'s gradient at an exact zero is JAX's.

The module imports no JAX at its top, so the ranks stay light.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

from repro_torch import sparse_train as tst
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.train import step as tstep
from test_torch_sharded_model import _as_port, _jax_mesh, _numpy, _to_torch

GEOM = dict(bm=8, bk=32, bn=32)
TOL = dict(rtol=1e-5, atol=1e-5)
#: AdamW's eps as ``tests/test_torch_sharded_model.py`` sets it (see there)
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-6)
DST = dict(target=0.5, begin=0, end=6, update_every=2, min_size=64)
STEPS = 6
#: the step before which the gradients at the masked point are compared (the
#: first after the first refresh), and the step the skip run poisons
AFTER_REFRESH = 2
DEADLINE = 180.0
RUNS = [("deepseek-7b", (2, 2)), ("deepseek-7b", (1, 4)), ("deepseek-7b", (4, 1)),
        ("qwen3-moe-235b-a22b", (2, 2)), ("mamba2-780m", (2, 2))]
#: reduced deepseek-7b-ReLU whose FFN and head cut through 32-wide mask blocks
DEEPSEEK = dict(activation="relu", d_ff=96, vocab_size=192)


def _cfg_of(arch, cfg):
    if arch == "deepseek-7b":
        return dataclasses.replace(cfg, **DEEPSEEK)
    if arch == "qwen3-moe-235b-a22b":
        return dataclasses.replace(cfg, activation="relu", moe_a2a_quant=False)
    return cfg


def port_cfg(arch):
    return _cfg_of(arch, reduce_config(get_config(arch)))


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return _cfg_of(arch, jreduce_config(jget_config(arch)))


def _batches(vocab):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, vocab, (4, 16)).astype(np.int32)} for _ in range(STEPS)]


def _host(tree: dict) -> dict:
    return {p: np.asarray(x, np.float32) for p, x in tree.items()}


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _setup(arch, shape, params):
    cfg = port_cfg(arch)
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    local = S.shard_tree(_to_torch(params), specs, policy)
    return cfg, policy, specs, local, Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)


def _gathered(tree, specs, policy) -> list:
    with torch.no_grad():
        return [x.detach().numpy().copy() for x in tadamw.tree_leaves(S.gather_tree(tree, specs, policy))]


def task_dst(arch, shape, params, batches, poison_at=None):
    """The controller's units and geometry, then per step the loss, the
    gradient norm and the skip flag, per refresh the scores, the masks and
    the report; the gradients at the masked point before step
    ``AFTER_REFRESH``, whether a poisoned step returned its input, and the
    gathered parameters after the last step."""
    cfg, policy, specs, local, rt = _setup(arch, shape, params)
    out = {"steps": [], "refreshes": []}
    with rt.use():
        ctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(**DST), local, specs=specs)
        out["units"], out["spec"] = list(ctrl.units), ctrl.spec()
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT), dynamic_sparsity=ctrl, guard_nonfinite=True)
        opt = tstep.init_train_state(cfg, local)
        masks = ctrl.masks()
        for i, b in enumerate(batches):
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            if i == AFTER_REFRESH:
                # the gradients at the point this step trains from: a masked copy
                point = S.map_specs(lambda x, _: x.detach().clone(), local, specs)
                tst.apply_block_masks(point, masks, ctrl.spec(),
                                      tst.leaf_cuts(point, specs, S.rank_index(policy)))
                _, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, point, tb,
                                                     shards=TT.shards_of(cfg))
                out["grads"] = _gathered(tstep.tree_unflatten(point, grads), specs, policy)
            before = _gathered(local, specs, policy) if i == poison_at else None
            local, opt, m = fn(local, opt, tb, masks, int(i == poison_at))
            out["steps"].append((float(m["loss"]), float(m["grad_norm"]), int(m["nonfinite"])))
            if before is not None:
                out["skip_returned_input"] = all(
                    np.array_equal(a, b) for a, b in zip(_gathered(local, specs, policy), before))
            if ctrl.should_update(i):
                w, g = _host(m["dst_w_scores"]), _host(m["dst_g_scores"])
                rep = ctrl.update(i, m["dst_w_scores"], m["dst_g_scores"])
                out["refreshes"].append({"step": i, "w": w, "g": g,
                                         "masks": {p: u.mask.copy() for p, u in ctrl.units.items()},
                                         "report": (rep["pruned"], rep["regrown"], rep["sparsity"])})
                masks = ctrl.masks()
    out["params"] = _gathered(local, specs, policy)
    return out


def task_launch(argv, shape=None):
    """The launcher's standard output on this rank; with ``shape``, on that
    ``(data, model)`` mesh in place of ``make_local_mesh()``'s."""
    buf = io.StringIO()
    local = tlaunch.make_local_mesh
    if shape is not None:
        tlaunch.make_local_mesh = lambda: mesh(shape, ("data", "model"))
    try:
        with contextlib.redirect_stdout(buf):
            tlaunch.main(argv)
    finally:
        tlaunch.make_local_mesh = local
    return buf.getvalue()


def task_mismatched_masks():
    """A controller whose masks differ on one rank: its next refresh raises
    on every rank."""
    cfg = port_cfg("deepseek-7b")
    policy = S.ShardingPolicy(mesh=mesh((2, 2), ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    from repro_torch.models.common import init_params

    local = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu", policy=policy)
    rt = Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)
    ctrl = tst.DynamicSparsityController(tst.DynamicSparsityConfig(**DST), local, rt=rt, specs=specs)
    if torch.distributed.get_rank() == 3:
        ctrl.units["['lm_head']"].mask[0, 0, 0] = False
    scores = {p: torch.ones(u.mask.shape) for p, u in ctrl.units.items()}
    try:
        ctrl.update(1, scores, scores)
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# fixtures: the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jparams():
    """``{arch: (JAX params, the port's params as numpy)}`` (fp32)."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    out = {}
    for arch in dict(RUNS):
        jp = jinit_params(JM.param_specs(_jax_cfg(arch)), jax.random.PRNGKey(0), dtype=jnp.float32)
        out[arch] = jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(arch)))
    return out


@pytest.fixture(scope="module")
def jax_run(jparams):
    """JAX's run per (arch, mesh shape, poisoned step): the controller's
    units, spec and per-refresh scores, masks and reports, per step the
    loss, gradient norm and skip flag, the gradients before step
    ``AFTER_REFRESH`` and the parameters after the last step (the port's
    leaf order).  One jitted step per (arch, shape)."""
    steps, memo = {}, {}

    def get(arch, shape, poison_at=None):
        key = (arch, shape, poison_at)
        if key in memo:
            return memo[key]
        import jax
        import jax.numpy as jnp

        from repro import runtime as jrt
        from repro import sparse_train as jst
        from repro.models import model as JM
        from repro.optim import adamw as jadamw
        from repro.parallel.sharding import ShardingPolicy
        from repro.train import step as jstep

        jcfg, jp = _jax_cfg(arch), jparams[arch][0]
        out = {"steps": [], "refreshes": []}
        with jrt.use(jrt.Runtime(backend="reference", sharding=ShardingPolicy(mesh=_jax_mesh(shape)), **GEOM)):
            jctrl = jst.DynamicSparsityController(jst.DynamicSparsityConfig(**DST), jp)
            spec = jctrl.spec()
            out["units"], out["spec"] = list(jctrl.units), spec
            if (arch, shape) not in steps:
                steps[arch, shape] = (
                    jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), dynamic_sparsity=jctrl,
                                                  guard_nonfinite=True)),
                    jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, jcfg, b))))
            jfn, jgrad = steps[arch, shape]
            jopt, jmasks = jadamw.init_opt_state(jp), jctrl.masks()
            for i, b in enumerate(_batches(jcfg.vocab_size)):
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if i == AFTER_REFRESH:
                    out["grads"] = _as_port(jgrad(jst.apply_block_masks(jp, jmasks, spec), jb), port_cfg(arch))
                jp, jopt, jm = jfn(jp, jopt, jb, jmasks, jnp.int32(i == poison_at))
                jm = jax.device_get(jm)
                out["steps"].append((float(jm["loss"]), float(jm["grad_norm"]), int(jm["nonfinite"])))
                if jctrl.should_update(i):
                    rep = jctrl.update(i, jm["dst_w_scores"], jm["dst_g_scores"])
                    out["refreshes"].append({"step": i, "w": _host(jm["dst_w_scores"]),
                                             "g": _host(jm["dst_g_scores"]),
                                             "masks": {p: u.mask.copy() for p, u in jctrl.units.items()},
                                             "report": (rep["pruned"], rep["regrown"], rep["sparsity"])})
                    jmasks = jctrl.masks()
        out["params"] = _as_port(jp, port_cfg(arch))
        memo[key] = out
        return out

    return get


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _margin(scores, chosen, pool_of) -> float | None:
    """How far the chosen blocks' scores stand from the rest of their pool:
    the last kept against the first dropped.  ``None`` when the pool is all
    chosen or none of it is."""
    rest = pool_of & ~chosen
    if not chosen.any() or not rest.any():
        return None
    return float(scores[chosen].min() - scores[rest].max())


def _assert_margins(got: dict, want: dict, prev_masks: dict) -> int:
    """At one refresh: every pruned block's weight score below every kept
    one's, every regrown block's gradient score above every other inactive
    one's, in JAX's scores, by more than twice the largest difference
    between the two packages' scores of that layer (or with those scores
    bit-equal), so the port's own scores must select the same blocks.
    Returns the selections checked."""
    checked = 0
    for p, mask in want["masks"].items():
        old = prev_masks[p]
        for key, pools in (("w", lambda l: (old[l] & mask[l], old[l])),  # kept among the active
                           ("g", lambda l: (~old[l] & mask[l], ~old[l]))):  # regrown among the inactive
            ours, theirs = got[key][p].reshape(mask.shape), want[key][p].reshape(mask.shape)
            for l in range(mask.shape[0]):
                m = _margin(theirs[l], *pools(l))
                if m is None:
                    continue
                err = float(np.abs(ours[l] - theirs[l]).max())
                assert m > 2 * err or (err == 0 and m >= 0), f"{p}[{l}] {key}: margin {m}, score difference {err}"
                checked += 1
    return checked


def _assert_run_matches(got: dict, want: dict):
    assert got["units"] == want["units"] and got["spec"] == want["spec"]
    for (loss, gnorm, skip), (jloss, jgnorm, jskip) in zip(got["steps"], want["steps"], strict=True):
        assert skip == jskip
        np.testing.assert_allclose(loss, jloss, **TOL)
        np.testing.assert_allclose(gnorm, jgnorm, **TOL)
    prev = {p: np.ones_like(m) for p, m in want["refreshes"][0]["masks"].items()}
    checked = 0
    for r, jr in zip(got["refreshes"], want["refreshes"], strict=True):
        assert r["step"] == jr["step"] and r["report"] == jr["report"]
        assert list(r["w"]) == list(jr["w"]) == want["units"]
        for p in want["units"]:
            np.testing.assert_allclose(r["w"][p], jr["w"][p], **TOL, err_msg=p)
            np.testing.assert_allclose(r["g"][p], jr["g"][p], **TOL, err_msg=p)
            np.testing.assert_array_equal(r["masks"][p], jr["masks"][p], err_msg=p)
        checked += _assert_margins(r, jr, prev)
        prev = jr["masks"]
    assert checked > 0
    for g, jg in zip(got["grads"], want["grads"], strict=True):
        np.testing.assert_allclose(g, jg, **TOL)
    for t, j in zip(got["params"], want["params"], strict=True):
        np.testing.assert_allclose(t, j, **TOL)


def _assert_ranks_agree(outs: list):
    for out in outs[1:]:
        for r, r0 in zip(out["refreshes"], outs[0]["refreshes"], strict=True):
            assert r["report"] == r0["report"]
            for p, m in r["masks"].items():
                np.testing.assert_array_equal(m, r0["masks"][p], err_msg=p)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", RUNS, ids=lambda x: x if isinstance(x, str) else f"data{x[0]}-model{x[1]}")
def test_sharded_dynamic_sparse_training_matches_jax(pool, jparams, jax_run, arch, shape):
    want = jax_run(arch, shape)
    outs = pool.run(task_dst, arch, shape, jparams[arch][1], _batches(port_cfg(arch).vocab_size), deadline=DEADLINE)
    _assert_ranks_agree(outs)
    for out in outs:
        _assert_run_matches(out, want)
    # the schedule reached its target and the norm gains are units too
    assert want["refreshes"][-1]["report"][2] > 0.45
    assert any("['ln1']" in p or "['ln']" in p for p in want["units"])


def test_units_are_the_global_leaves_when_shards_cut_blocks():
    """The controller builds its units from the global shapes: on a mesh
    its ``spec()`` and mask shapes are the unsharded controller's, though
    a rank's slices of the FFN and head are 24 columns (block 32)."""
    cfg = port_cfg("deepseek-7b")
    from repro_torch.models.common import init_params

    params = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu")
    policy = S.ShardingPolicy(mesh=type("M", (), {"axis_names": ("data", "model"),
                                                  "shape": {"data": 1, "model": 4}})())
    specs = policy.param_pspecs(TM.param_specs(cfg))
    index_of = lambda e: {"model": (4, 3), "data": (1, 0)}[e]
    local = S.map_specs(lambda x, sp: S.shard_slice(x, sp, index_of).contiguous(), params, specs)
    rt = Runtime(backend="reference", device="cpu", **GEOM)
    whole = tst.DynamicSparsityController(tst.DynamicSparsityConfig(**DST), params, rt=rt)
    cuts = tst.leaf_cuts(local, specs, index_of)
    assert cuts["['layers']['mlp']['w_gate']"] == tst.Cut((2, 64, 96), (0, 0, 72))
    assert all(cuts[p].shape == tst.stacked_leaves(params)[p].shape for p in whole.units)
    # the rank's slices masked by their slice of each mask equal the masked whole, sliced
    rng = np.random.default_rng(0)
    masks = {p: torch.from_numpy(rng.random(m.shape) < 0.5) for p, m in whole.masks().items()}
    tst.apply_block_masks(params, masks, whole.spec())
    tst.apply_block_masks(local, masks, whole.spec(), cuts)
    for x, y in zip(tadamw.tree_leaves(local), tadamw.tree_leaves(S.map_specs(
            lambda x, sp: S.shard_slice(x, sp, index_of), params, specs))):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="specs="):
        tst.DynamicSparsityController(tst.DynamicSparsityConfig(**DST), local, rt=rt.replace(sharding=policy))


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), (2, 2)], ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_partial_scores_sum_to_the_global_scores(shape):
    """Each rank's partial block scores of its slice, summed over the ranks
    that hold distinct slices, equal the whole tensor's block scores (the
    blocks a slice boundary cuts summed from two ranks); its element mask
    is the whole element mask's slice."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 40, 96)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 5, 3)) < 0.5)
    block, spec = (8, 32), (None, "data", "model")
    sizes = dict(zip(("data", "model"), shape))
    total = torch.zeros(3, 5, 3)
    for d in range(sizes["data"]):
        for m in range(sizes["model"]):
            index_of = lambda e, d=d, m=m: {"data": (sizes["data"], d), "model": (sizes["model"], m)}[e]
            part = S.shard_slice(x, spec, index_of)
            full, offsets = S.shard_extent(tuple(part.shape), spec, index_of)
            assert full == tuple(x.shape)
            total += tst.shard_block_scores(part, block, offsets, full)
            elem = tst.shard_block_mask(mask, block, offsets, tuple(part.shape))
            assert torch.equal(elem, S.shard_slice(tst.expand_block_mask(mask, block), spec, index_of))
    np.testing.assert_allclose(total.numpy(), tst.block_abs_sum(x, block).numpy(), rtol=1e-6, atol=1e-6)


def test_skipped_step_after_refresh_returns_its_input_on_a_mesh(pool, jparams, jax_run):
    """A NaN loss on the step right after the first refresh (which pruned
    blocks) is skipped on every rank: the gathered parameters are the ones
    it was given, the blocks its mask had just zeroed among them, and the
    run goes on equal to JAX's guarded run with the same poison."""
    arch, shape = "deepseek-7b", (2, 2)
    want = jax_run(arch, shape, AFTER_REFRESH)
    assert want["steps"][AFTER_REFRESH][2] == 1 and want["refreshes"][0]["report"][0] > 0
    outs = pool.run(task_dst, arch, shape, jparams[arch][1], _batches(port_cfg(arch).vocab_size), AFTER_REFRESH,
                    deadline=DEADLINE)
    _assert_ranks_agree(outs)
    for out in outs:
        assert out["skip_returned_input"]
        _assert_run_matches(out, want)


def test_ranks_whose_masks_differ_raise(pool):
    for err in pool.run(task_mismatched_masks, deadline=DEADLINE):
        assert err is not None and "the ranks' masks differ" in err


#: the launcher's refresh lines less their plan-edit time, and its Wdens
_REFRESH = re.compile(r"^(dst refresh .*) plan-edit .*$|(Wdens=\S+)", re.M)


def _dst_lines(text: str) -> list:
    return [a or b for a, b in _REFRESH.findall(text)]


def test_launcher_dynamic_sparsity_on_a_mesh_prints_the_one_rank_lines(pool):
    argv = ["--smoke", "--device", "cpu", "--backend", "reference", "--steps", "6", "--seq", "16", "--batch", "4",
            "--dynamic-sparsity", "target=0.5,update_every=2,end=6"]
    one = task_launch(argv)
    outs = pool.run(task_launch, argv, (2, 2), deadline=DEADLINE)
    want = _dst_lines(one)
    assert len([x for x in want if x.startswith("dst refresh")]) == 3 and "Wdens=1.00" in want
    assert _dst_lines(outs[0]) == want
    assert "dynamic sparsity:" in outs[0] and "done" in outs[0]
    assert all(out == "" for out in outs[1:])


def test_relu_gradient_at_an_exact_zero_is_jaxs():
    """JAX's ``relu`` is ``jnp.maximum(x, 0)``: at an exact zero its
    gradient is 1/2.  A pruned norm-gain block feeding the only rows an
    expert's gate keeps makes such zeros, so the port's must match."""
    import jax
    import jax.numpy as jnp

    from repro.models.common import ACTIVATIONS as JACT
    from repro_torch.models.common import ACTIVATIONS

    x = np.array([-1.0, 0.0, 2.0], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    ACTIVATIONS["relu"](t).sum().backward()
    want = jax.grad(lambda v: jnp.sum(JACT["relu"](v)))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(), [0.0, 0.5, 1.0])
