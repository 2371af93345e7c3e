"""The expert-parallel MoE differentiated, and the sharded MoE model
trained, on 4 CPU ranks against the JAX package.

One pool of 4 spawned ranks per module (``repro_torch.parallel.rehearsal``)
builds ``(data, model)`` meshes; the JAX side runs in the test process on
``Mesh(devices[:4].reshape(shape), ("data", "model"))`` of the 8 host
devices ``tests/conftest.py`` forces.  The all-to-all's payload is plain
(``a2a_quant`` off): with the int8 payload a value within rounding of a half
step can round to the other level in the two packages, and 1e-5 would not
hold.  Capacity is counted per shard in both packages.

* The layer (``MoEConfig(d_model=16, num_experts=8, top_k=2, d_ff=32,
  activation="relu")``, fp32) through ``moe_ffn(mesh=...)`` with global
  tensors: each rank's gradients of ``sum(y * w)`` are its own shard's
  contribution, and their sum over the ranks is within rtol = atol = 1e-5
  of ``jax.grad`` of JAX's sharded ``moe_ffn`` on ``(data 2, model 2)``, on
  the sequence-split and the decode branch.
* Reduced qwen3-moe-235b-a22b with a ReLU gate (8 experts top-2), sharded
  as a whole model: loss and every gradient within 1e-5 of JAX's sharded
  loss under ``jax.jit``, and one ``make_train_step`` step's parameters
  within 1e-5 of JAX's sharded gradients through JAX's AdamW.

The module imports no JAX at its top, so the ranks stay light.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.train import step as tstep

MESHES = [(2, 2), (1, 4), (4, 1)]
CFG = dict(d_model=16, num_experts=8, top_k=2, d_ff=32, activation="relu", a2a_quant=False)
GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
#: AdamW's eps is 1e-6 here (1e-8 by default): its first update g / (|g| + eps)
#: turns an entry whose gradient is within fp32 summation-order noise of 0
#: into a near-random step of up to lr (seen: 1.4e-5 on 1 of 8192 entries at
#: eps 1e-8), so a reduction order other than XLA's shows as a parameter
#: difference no gradient check would call one; at eps 1e-6 the update is
#: smooth at the scale of the 1e-5 tolerance.  The gradients themselves are
#: held at 1e-5 unchanged.
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-6)
DEADLINE = 120.0
ARCH = "qwen3-moe-235b-a22b"


def port_cfg():
    return dataclasses.replace(reduce_config(get_config(ARCH)), activation="relu", moe_a2a_quant=False)


def _jax_cfg():
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return dataclasses.replace(jreduce_config(jget_config(ARCH)), activation="relu", moe_a2a_quant=False)


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _as_port(jtree):
    import jax

    from repro_torch.convert import params_from_jax

    tree = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jtree), port_cfg())
    return [x.numpy() for x in tadamw.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def task_layer_grads(shape, params, x, w, seq_sharded, backend):
    """``sum(moe_ffn(mesh) * w)``'s gradients on this rank: the router's,
    the experts' and ``x``'s (the rank's contribution)."""
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    rt = Runtime(backend=backend, device="cpu", **GEOM)
    y = TMoE.moe_ffn(tp, TMoE.MoEConfig(**CFG), xt, rt=rt, mesh=mesh(shape, ("data", "model")),
                     seq_sharded=seq_sharded)
    (y * torch.from_numpy(w)).sum().backward()
    return {**{k: v.grad.numpy() for k, v in tp.items()}, "x": xt.grad.numpy()}, y.detach().numpy()


def _setup(shape, params):
    cfg = port_cfg()
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    local = S.shard_tree(_to_torch(params), specs, policy)
    return cfg, policy, specs, local, Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)


def task_model_grads(shape, params, batch):
    cfg, policy, specs, local, rt = _setup(shape, params)
    with rt.use():
        sh = TT.shards_of(cfg)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        with torch.no_grad():
            full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
    return float(loss), [x.numpy() for x in tadamw.tree_leaves(full)]


def task_step(shape, params, batch):
    cfg, policy, specs, local, rt = _setup(shape, params)
    with rt.use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT), sparsity_taps=True)
        p2, _, m = fn(local, tstep.init_train_state(cfg, local), {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            full = S.gather_tree(p2, specs, policy)
    return (float(m["loss"]), float(m["grad_norm"]), [x.detach().numpy() for x in tadamw.tree_leaves(full)],
            m["A_density"].numpy(), dist.get_rank())


# ---------------------------------------------------------------------------
# fixtures and tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def layer_params():
    import jax

    from repro.models import moe as JMoE
    from repro.models.common import init_params as jinit_params

    jp = jinit_params(JMoE.moe_specs(JMoE.MoEConfig(**CFG)), jax.random.PRNGKey(0), dtype=np.float32)
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def model_params():
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    jp = jinit_params(JM.param_specs(_jax_cfg()), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), port_cfg()))


@pytest.fixture(scope="module")
def jax_model(model_params):
    memo = {}

    def get(shape):
        if shape not in memo:
            import jax
            import jax.numpy as jnp

            from repro import runtime as jrt
            from repro.models import model as JM
            from repro.parallel.sharding import ShardingPolicy

            jcfg, jp = _jax_cfg(), model_params[0]
            batch = {k: jnp.asarray(v) for k, v in _batch().items()}
            with jrt.use(jrt.Runtime(backend="reference", sharding=ShardingPolicy(mesh=_jax_mesh(shape)), **GEOM)):
                loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b)))(jp, batch)
            memo[shape] = float(loss), grads
        return memo[shape]

    return get


@pytest.fixture(scope="module")
def jax_layer(layer_params):
    """``jax.grad`` of JAX's sharded ``moe_ffn`` on the ``(2, 2)`` mesh per
    branch, once each (an eager ``shard_map`` and its transpose compile at
    every call)."""
    memo = {}

    def get(branch):
        if branch not in memo:
            import jax
            import jax.numpy as jnp

            from repro.models import moe as JMoE

            x = _x((4, 8, 16) if branch == "seq" else (4, 1, 16))
            w = _x(x.shape, seed=2)

            def f(p, xx):
                y = JMoE.moe_ffn(p, JMoE.MoEConfig(**CFG), xx, mesh=_jax_mesh((2, 2)), seq_sharded=branch == "seq")
                return jnp.sum(y * jnp.asarray(w)), y

            (_, jy), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                {k: jnp.asarray(v) for k, v in layer_params.items()}, jnp.asarray(x))
            memo[branch] = x, w, np.asarray(jy), {k: np.asarray(v) for k, v in jg.items()}, np.asarray(jgx)
        return memo[branch]

    return get


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("branch", ["seq", "decode"])
def test_expert_parallel_layer_gradients_match_jax_grad(pool, layer_params, jax_layer, branch, backend):
    x, w, jy, jg, jgx = jax_layer(branch)
    out = pool.run(task_layer_grads, (2, 2), layer_params, x, w, branch == "seq", backend, deadline=DEADLINE)
    for _, y in out:
        np.testing.assert_allclose(y, jy, **TOL)
    for k in layer_params:
        np.testing.assert_allclose(sum(g[k] for g, _ in out), jg[k], **TOL)
    np.testing.assert_allclose(sum(g["x"] for g, _ in out), jgx, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_sharded_moe_model_loss_and_gradients_match_jax(pool, model_params, jax_model, shape):
    jloss, jgrads = jax_model(shape)
    want = _as_port(jgrads)
    for loss, grads in pool.run(task_model_grads, shape, model_params[1], _batch(), deadline=DEADLINE):
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
        for g, j in zip(grads, want):
            np.testing.assert_allclose(g, j, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_sharded_moe_train_step_matches_jax(pool, model_params, jax_model, shape):
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw

    jloss, jgrads = jax_model(shape)
    jp = model_params[0]
    jp2, _, jm = jadamw.apply_updates(jp, jgrads, jadamw.init_opt_state(jp), jadamw.OptConfig(**OPT))
    want = _as_port(jp2)
    out = pool.run(task_step, shape, model_params[1], _batch(), deadline=DEADLINE)
    for loss, gnorm, params, a_density, _ in out:
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        for t, j in zip(params, want):
            np.testing.assert_allclose(t, j, **TOL)
        np.testing.assert_array_equal(a_density, out[0][3])  # the taps are global: equal on every rank
    del jax, jnp
