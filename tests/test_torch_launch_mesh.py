"""``launch/mesh.py``, the train launcher on a mesh and the sharded
checkpoint, on 4 CPU ranks.

* The production meshes' shapes and axis names equal the JAX package's
  (read off ``repro.launch.mesh`` with ``jax.make_mesh`` stubbed: the JAX
  mesh needs 256 or 512 devices); the local mesh is ``(1, world)`` over
  ``("data", "model")``, on ``cpu`` under gloo.
* A process group of the wrong size raises a ``ValueError`` naming the size
  the mesh needs, from ``make_production_mesh`` and from the launcher's
  ``--multi-pod``.
* ``launch.train.main --smoke`` on 4 ranks over a ``(2, 2)`` mesh (its
  ``make_local_mesh`` replaced by one): rank 0 prints each plan line with
  the ``imbalance`` column in the JAX launcher's format and the same step-1
  loss as one process; the other ranks print nothing.
* ``init_params(policy=)`` keeps on every rank exactly its ``local_shard``
  of the unsharded draw, and ``gather_to_first`` puts a leaf's slices back
  together on the first rank alone (``None`` on the others).
* A train state saved under ``(2, 2)`` (gathered leaf by leaf to rank 0,
  which writes the JAX package's format) restores with ``shardings=``
  under ``(1, 4)``: every rank's leaves bit-equal to its ``local_shard`` of
  the stored arrays, and a third step from there within rtol = atol = 1e-5
  of an uninterrupted run's.  The same save and restore, bit-equal, for
  the trees of reduced deepseek-v2 (MLA heads over ``model``, the experts
  expert-parallel) and reduced zamba2 (Mamba2 heads over ``model``, the
  shared block's groups as lists of lists).
* ``launch.train.main --smoke --arch mamba2-780m`` on 4 ranks over a
  ``(2, 2)`` mesh: tensor-parallel Mamba2, the same step-1 loss as one
  process.

The module imports no JAX at its top, so the ranks stay light.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models.common import init_params
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.train import step as tstep

GEOM = dict(bm=8, bk=16, bn=16)
OPT = dict(lr=1e-3, warmup_steps=1)
TOL = dict(rtol=1e-5, atol=1e-5)
DEADLINE = 120.0
SMOKE = ["--smoke", "--device", "cpu", "--backend", "reference", "--steps", "2", "--seq", "16", "--batch", "4",
         "--arch", "deepseek-7b"]
#: the JAX launcher's plan line (``src/repro/launch/train.py``), imbalance column included
PLAN_LINE = re.compile(r"plan key=.+ side=[AB] total_work=\d+/\d+ blocks skipped=\d+% "
                       r"imbalance=\d+\.\d\dx over \d+ devices$")


def _cfg():
    return dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def task_meshes():
    m = tmesh.make_local_mesh()
    try:
        tmesh.make_production_mesh()
    except ValueError as e:
        err = str(e)
    return tuple(m.shape), tuple(m.mesh_dim_names), m.device_type, err


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
    except ValueError as e:
        return f"ValueError: {e}"
    finally:
        tlaunch.make_local_mesh = local
    return buf.getvalue()


def _sharded(shape):
    cfg = _cfg()
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    return cfg, policy, Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)


def task_sharded_init_and_gather():
    """Under (2, 2): each rank's ``init_params(policy=)`` leaves against
    its ``local_shard`` of the unsharded draw, and every leaf gathered back
    by ``gather_to_first`` (``None`` off the first rank)."""
    cfg, policy, _ = _sharded((2, 2))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    whole = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu")
    local = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu", policy=policy)
    cut = S.map_specs(lambda x, sp: S.local_shard(x, sp, policy), whole, specs)
    same = [torch.equal(a, b) and a.is_contiguous() for a, b in
            zip(tadamw.tree_leaves(local), tadamw.tree_leaves(cut))]
    back = S.map_specs(lambda x, sp: S.gather_to_first(x, sp, policy), local, specs)
    gathered = [None if x is None else torch.equal(x, w)
                for x, w in zip(tadamw.tree_leaves(back), tadamw.tree_leaves(whole))]
    return dist.get_rank(), same, gathered, sum(len(sp) > 0 and any(sp) for sp in S.spec_leaves(specs))


def task_train_and_save(ckpt):
    """Under (2, 2): two steps, a checkpoint, then a third step; the
    gathered parameters after it."""
    cfg, policy, rt = _sharded((2, 2))
    specs = tstep.state_specs(cfg, policy)
    data = SyntheticLM(cfg.vocab_size, 16, 4)
    with rt.use():
        params = S.shard_tree(init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu"),
                              specs["params"], policy)
        opt = tstep.init_train_state(cfg, params)
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT))
        for i in range(2):
            params, opt, _ = fn(params, opt, data.batch_at(i, device="cpu"))
        tman.save(ckpt, 2, {"params": params, "opt": opt}, shardings=specs)
        params, opt, m = fn(params, opt, data.batch_at(2, device="cpu"))
        full = S.gather_tree(params, specs["params"], policy)
    return [x.detach().numpy() for x in tadamw.tree_leaves(full)], float(m["loss"])


def task_restore_and_resume(ckpt):
    """Under (1, 4): restore step 2 onto this mesh's shards, then the third
    step; the restored leaves, their specs and the gathered parameters."""
    cfg, policy, rt = _sharded((1, 4))
    specs = tstep.state_specs(cfg, policy)
    data = SyntheticLM(cfg.vocab_size, 16, 4)
    with rt.use():
        like_p = S.shard_tree(init_params(TM.param_specs(cfg), seed=1, dtype=torch.float32, device="cpu"),
                              specs["params"], policy)
        step, state = tman.restore_latest(ckpt, {"params": like_p, "opt": tstep.init_train_state(cfg, like_p)},
                                          shardings=specs)
        restored = {"params": [x.clone().numpy() for x in tadamw.tree_leaves(state["params"])],
                    "m": [x.clone().numpy() for x in tadamw.tree_leaves(state["opt"].m)]}
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT))
        params, _, m = fn(state["params"], state["opt"], data.batch_at(2, device="cpu"))
        full = S.gather_tree(params, specs["params"], policy)
    return (step, state["opt"].step, restored, S.spec_leaves(specs["params"]), dist.get_rank(),
            [x.detach().numpy() for x in tadamw.tree_leaves(full)], float(m["loss"]))


def task_family_save(arch, ckpt):
    """Under (2, 2): ``arch``'s reduced train state after one step, saved."""
    cfg = reduce_config(get_config(arch))
    policy = S.ShardingPolicy(mesh=mesh((2, 2), ("data", "model")))
    specs = tstep.state_specs(cfg, policy)
    with Runtime(backend="reference", device="cpu", sharding=policy, **GEOM).use():
        params = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu", policy=policy)
        opt = tstep.init_train_state(cfg, params)
        params, opt, _ = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT))(
            params, opt, SyntheticLM(cfg.vocab_size, 16, 4).batch_at(0, device="cpu"))
        tman.save(ckpt, 1, {"params": params, "opt": opt}, shardings=specs)


def task_family_restore(arch, ckpt):
    """Under (1, 4): the saved state restored onto this mesh's shards; the
    leaves, their specs and this rank."""
    cfg = reduce_config(get_config(arch))
    policy = S.ShardingPolicy(mesh=mesh((1, 4), ("data", "model")))
    specs = tstep.state_specs(cfg, policy)
    with Runtime(backend="reference", device="cpu", sharding=policy, **GEOM).use():
        like = init_params(TM.param_specs(cfg), seed=1, dtype=torch.float32, device="cpu", policy=policy)
        step, state = tman.restore_latest(ckpt, {"params": like, "opt": tstep.init_train_state(cfg, like)},
                                          shardings=specs)
    return (step, [x.numpy() for x in tadamw.tree_leaves(state["params"])],
            [x.numpy() for x in tadamw.tree_leaves(state["opt"].v)], S.spec_leaves(specs["params"]), dist.get_rank())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


def test_mesh_shapes_and_names_match_jax(pool, monkeypatch):
    from repro.launch import mesh as jmesh

    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod in (False, True):
        assert tmesh.PRODUCTION_SHAPES[multi_pod] == jmesh.make_production_mesh(multi_pod=multi_pod)
    jshape, jnames = jmesh.make_local_mesh()  # (1, devices) over ("data", "model")
    for got_shape, got_names, device, err in pool.run(task_meshes, deadline=DEADLINE):
        assert got_shape == (jshape[0], 4) and got_names == jnames and device == "cpu"
        assert "needs a process group of 256 ranks; this one has 4" in err


def test_production_mesh_and_multi_pod_raise_on_the_wrong_world_size(pool):
    with pytest.raises(ValueError, match="needs a process group of 256 ranks; this one has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs a process group of 512 ranks; this one has 1"):
        tlaunch.main(SMOKE + ["--multi-pod"])
    for out in pool.run(task_launch, SMOKE + ["--multi-pod"], deadline=DEADLINE):
        assert out.startswith("ValueError:") and "needs a process group of 512 ranks; this one has 4" in out


def test_launcher_on_four_ranks_prints_the_imbalance_lines(pool, capsys):
    outs = pool.run(task_launch, SMOKE, (2, 2), deadline=DEADLINE)
    assert all(o == "" for o in outs[1:])  # only rank 0 prints
    lines = outs[0].splitlines()
    plans = [ln for ln in lines if ln.startswith("plan key=")]
    assert plans and all(PLAN_LINE.match(ln) for ln in plans), plans
    assert all(ln.endswith("over 2 devices") for ln in plans)
    assert lines[-1] == "done"
    tlaunch.main(SMOKE)  # one process, no mesh: the same step-1 line
    one = capsys.readouterr().out.splitlines()
    step1 = lambda ls: next(ln for ln in ls if ln.startswith("step     1 ")).split(" gnorm")[0]
    assert step1(lines) == step1(one)
    assert not any("imbalance" in ln for ln in one)


def test_sharded_init_keeps_local_shards_and_gather_to_first_rebuilds(pool):
    for rank, same, gathered, n_sharded in pool.run(task_sharded_init_and_gather, deadline=DEADLINE):
        assert same and all(same)
        assert n_sharded > 0  # the (2, 2) specs shard leaves, over data and over model
        if rank == 0:
            assert all(g is True for g in gathered)
        else:
            assert all(g is None for g in gathered)


def test_save_under_2x2_restore_under_1x4_is_bit_equal_and_resumes(pool, tmp_path):
    ckpt = tmp_path / "ckpt"
    uninterrupted = pool.run(task_train_and_save, str(ckpt), deadline=DEADLINE)
    with np.load(ckpt / "step_000000000002" / "arrays.npz") as z:
        stored = {k: z[k] for k in z.files}
    assert "params/lm_head" in stored and stored["params/embed"].shape == (256, 64)  # gathered, whole
    cfg = _cfg()
    names = sorted(k for k in stored if k.startswith("params/"))
    outs = pool.run(task_restore_and_resume, str(ckpt), deadline=DEADLINE)
    for step, opt_step, restored, specs, rank, params, loss in outs:
        assert step == 2 and opt_step == 2
        index_of = lambda e: {"model": (4, rank), "data": (1, 0)}[e]
        # tree_leaves order (sorted dict keys, lists in order) is the stored paths' order only within a
        # list of layers; take each leaf's path from the spec tree's walk instead
        paths = _paths(TM.param_specs(cfg))
        assert sorted(paths) == names
        for path, spec, got, m in zip(paths, specs, restored["params"], restored["m"]):
            want = S.shard_slice(torch.from_numpy(stored[path]), spec, index_of).numpy()
            np.testing.assert_array_equal(got, want)
            mpath = "opt/m/" + path[len("params/"):]
            np.testing.assert_array_equal(m, S.shard_slice(torch.from_numpy(stored[mpath]), spec, index_of).numpy())
        assert loss == pytest.approx(uninterrupted[0][1], rel=1e-5)
        for t, u in zip(params, uninterrupted[0][0]):
            np.testing.assert_allclose(t, u, **TOL)


def _paths(specs, prefix="params"):
    """The checkpoint paths of a spec tree's leaves, in ``tree_leaves``
    order."""
    if isinstance(specs, dict):
        return [p for k in sorted(specs) for p in _paths(specs[k], f"{prefix}/{k}")]
    if isinstance(specs, list):
        return [p for i, v in enumerate(specs) for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-2.7b"])
def test_family_trees_save_under_2x2_and_restore_under_1x4_bit_equal(pool, tmp_path, arch):
    ckpt = tmp_path / "ckpt"
    pool.run(task_family_save, arch, str(ckpt), deadline=DEADLINE)
    with np.load(ckpt / "step_000000000001" / "arrays.npz") as z:
        stored = {k: z[k] for k in z.files}
    cfg = reduce_config(get_config(arch))
    paths = _paths(TM.param_specs(cfg))
    assert sorted(paths) == sorted(k for k in stored if k.startswith("params/"))
    sharded_over_model = 0
    for step, params, v, specs, rank in pool.run(task_family_restore, arch, str(ckpt), deadline=DEADLINE):
        assert step == 1
        index_of = lambda e: {"model": (4, rank), "data": (1, 0)}[e]
        for path, spec, got, vv in zip(paths, specs, params, v):
            want = S.shard_slice(torch.from_numpy(stored[path]), spec, index_of).numpy()
            np.testing.assert_array_equal(got, want)
            vpath = "opt/v/" + path[len("params/"):]
            np.testing.assert_array_equal(vv, S.shard_slice(torch.from_numpy(stored[vpath]), spec, index_of).numpy())
            sharded_over_model += "model" in spec
    assert sharded_over_model > 0  # MLA heads / Mamba2 heads / vocab cut over model


def test_launcher_on_four_ranks_trains_tensor_parallel_mamba2(pool, capsys):
    argv = SMOKE[:-1] + ["mamba2-780m"]
    outs = pool.run(task_launch, argv, (2, 2), deadline=DEADLINE)
    assert all(o == "" for o in outs[1:])  # only rank 0 prints
    lines = outs[0].splitlines()
    assert lines[-1] == "done"
    plans = [ln for ln in lines if ln.startswith("plan key=")]
    assert plans and all(PLAN_LINE.match(ln) and ln.endswith("over 2 devices") for ln in plans), plans
    tlaunch.main(argv)  # one process, no mesh: the same step-1 line
    one = capsys.readouterr().out.splitlines()
    step1 = lambda ls: next(ln for ln in ls if ln.startswith("step     1 ")).split(" gnorm")[0]
    assert step1(lines) == step1(one)
