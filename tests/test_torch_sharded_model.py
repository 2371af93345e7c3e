"""Whole dense models sharded on 4 CPU ranks, against the JAX package.

One pool of 4 spawned ranks per module (``repro_torch.parallel.rehearsal``:
gloo, a file rendezvous, a 60 s group timeout, a deadline per task) builds
a ``(data, model)`` mesh of each shape: ``(2, 2)``, ``(1, 4)`` and
``(4, 1)``.  Each rank holds the ``local_shard`` of every parameter under
``param_pspecs`` and runs the sharded model (FSDP over ``data``, tensor
parallel over ``model``, the vocab-parallel embedding, head and cross
entropy).  The JAX side runs in the test process: its loss and gradients
under ``jax.jit`` with ``Runtime(sharding=ShardingPolicy(mesh=Mesh(
devices[:4].reshape(shape), ("data", "model"))))`` on the 8 host devices
``tests/conftest.py`` forces (a ``Mesh(...)`` constructor: its axes are
Auto; ``jax.make_mesh`` fails there), and unsharded.

Models: reduced deepseek-7b with a ReLU gate (the fused TensorDash FFN on
the ``reference`` backend; 4 heads over 2 kv heads, so on ``(1, 4)`` the
K/V are replicated), reduced qwen3-4b (qk-norm, SiLU), and the first with
3 heads, 1 kv head, ``d_ff`` 125 and vocab 255 (nothing divides the model
axis: every body runs replicated over it), fp32 parameters from the JAX
initializer, a ``[4, 16]`` batch.  Tolerance rtol = atol =
1e-5 for logits, loss, every gradient and the parameters after one
``make_train_step`` step.

The module imports no JAX at its top, so the ranks stay light.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.train import step as tstep

MESHES = [(2, 2), (1, 4), (4, 1)]
ARCHS = ["deepseek-7b", "qwen3-4b"]
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


#: a reduced deepseek-7b-ReLU whose heads, FFN width and vocab divide no
#: model axis of 2 or 4: attention, the FFN, the embedding and the head run
#: replicated over ``model`` (the FFN sharded over ``model`` on neither mesh)
ODD = dict(activation="relu", num_heads=3, num_kv_heads=1, d_ff=125, vocab_size=255)


def _cfg_of(arch, reduce):
    base, _, odd = arch.partition(":")
    cfg = reduce(base)
    if odd:
        return dataclasses.replace(cfg, **ODD)
    return dataclasses.replace(cfg, activation="relu") if base == "deepseek-7b" else cfg


def port_cfg(arch):
    return _cfg_of(arch, lambda a: reduce_config(get_config(a)))


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return _cfg_of(arch, lambda a: jreduce_config(jget_config(a)))


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 255, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 255, (4, 16)).astype(np.int32)}


def _as_port(jtree, tcfg):
    """A JAX parameter-shaped tree in the port's leaf order, as numpy."""
    import jax

    from repro_torch.convert import params_from_jax

    tree = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jtree), tcfg)
    return [x.numpy() for x in tadamw.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _setup(arch, shape, params, backend):
    cfg = port_cfg(arch)
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    full = {k: v for k, v in _to_torch(params).items()}
    local = S.shard_tree(full, specs, policy)
    rt = Runtime(backend=backend, device="cpu", sharding=policy, **GEOM)
    return cfg, policy, specs, local, rt


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def task_loss_grads(arch, shape, params, batch, backend):
    """Loss, the gathered gradients (in ``tree_leaves`` order) and this
    rank's logits rows."""
    cfg, policy, specs, local, rt = _setup(arch, shape, params, backend)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use():
        sh = TT.shards_of(cfg)
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        lb = tstep.local_batch(cfg, batch, sh)
        with torch.no_grad():
            full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
            logits = TM.forward(local, cfg, lb)
    return float(loss), [x.numpy() for x in tadamw.tree_leaves(full)], logits.numpy(), sh.data_rank


def task_step(arch, shape, params, batch, microbatches):
    cfg, policy, specs, local, rt = _setup(arch, shape, params, "reference")
    with rt.use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT), microbatches=microbatches)
        opt = tstep.init_train_state(cfg, local)
        p2, o2, m = fn(local, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            full = S.gather_tree(p2, specs, policy)
    return float(m["loss"]), float(m["grad_norm"]), [x.detach().numpy() for x in tadamw.tree_leaves(full)]


def task_plan_counts(shape, params, batch):
    """One forward of reduced deepseek-7b-ReLU on the ``reference`` backend:
    the fused gates, the emitted plans (and their shapes) and the planned
    products this rank ran; then a second forward's plan-cache counts."""
    from repro_torch.runtime import backends as B
    from repro_torch.runtime import runtime as R

    cfg, policy, specs, local, rt = _setup("deepseek-7b", shape, params, "reference")
    seen = {"fused": 0, "planned": 0, "emitted": []}
    planned, fused, emitted = B.ReferenceBackend.matmul_planned, B.ReferenceBackend.matmul_fused, \
        R.plan_from_emitted_mask

    def count_planned(self, *a, **k):
        seen["planned"] += 1
        return planned(self, *a, **k)

    def count_fused(self, *a, **k):
        seen["fused"] += 1
        return fused(self, *a, **k)

    def count_emitted(mask, shape, *a, **k):
        seen["emitted"].append(tuple(shape))
        return emitted(mask, shape, *a, **k)

    B.ReferenceBackend.matmul_planned, B.ReferenceBackend.matmul_fused = count_planned, count_fused
    R.plan_from_emitted_mask = count_emitted
    try:
        with rt.use(), torch.no_grad():
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            lb = tstep.local_batch(cfg, tb, TT.shards_of(cfg))
            TM.forward(local, cfg, lb)
            counts = {**seen, "emitted": list(seen["emitted"])}
            TM.forward(local, cfg, lb)
    finally:
        B.ReferenceBackend.matmul_planned, B.ReferenceBackend.matmul_fused = planned, fused
        R.plan_from_emitted_mask = emitted
    return counts, rt.plan_cache.stats()


def task_vocab_ce(logits, labels):
    """The vocab-parallel cross entropy over the model axis of a ``(1, 4)``
    mesh: each rank's nll rows and the gradient of their mean on its
    slice."""
    sh = S.ModelShards(S.ShardingPolicy(mesh=mesh((1, 4), ("data", "model"))), None)
    v = logits.shape[-1] // sh.tp
    mine = torch.from_numpy(logits[:, sh.tp_rank * v:(sh.tp_rank + 1) * v]).requires_grad_()
    nll = S.vocab_parallel_ce(mine, torch.from_numpy(labels), sh.tp_rank * v, sh.model_group)
    nll.mean().backward()
    return nll.detach().numpy(), mine.grad.numpy()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jparams():
    """``{arch: (JAX params, the port's params as numpy)}`` (fp32, from the
    JAX initializer)."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    out = {}
    for arch in ARCHS + ["deepseek-7b:odd"]:
        jp = jinit_params(JM.param_specs(_jax_cfg(arch)), jax.random.PRNGKey(0), dtype=jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(arch))
        out[arch] = jp, _numpy(tp)
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def jax_ref(jparams):
    """JAX's loss and gradients per (arch, mesh shape or ``None``), each
    compiled once; with no mesh, also its logits."""
    memo = {}

    def get(arch, shape):
        if (arch, shape) not in memo:
            import jax
            import jax.numpy as jnp

            from repro import runtime as jrt
            from repro.models import model as JM
            from repro.parallel.sharding import ShardingPolicy

            jcfg = _jax_cfg(arch)
            jp = jparams[arch][0]
            batch = {k: jnp.asarray(v) for k, v in _batch().items()}
            pol = ShardingPolicy(mesh=_jax_mesh(shape)) if shape is not None else None
            with jrt.use(jrt.Runtime(backend="reference", sharding=pol, **GEOM)):
                loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b)))(jp, batch)
                logits = np.asarray(JM.forward(jp, jcfg, batch)) if shape is None else None
            memo[arch, shape] = float(loss), _as_port(grads, port_cfg(arch)), logits
        return memo[arch, shape]

    return get


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_loss_and_gradients_match_jax(pool, jparams, jax_ref, arch, shape, backend):
    jloss, jgrads, _ = jax_ref(arch, shape)
    uloss, ugrads, ulogits = jax_ref(arch, None)
    out = pool.run(task_loss_grads, arch, shape, jparams[arch][1], _batch(), backend, deadline=DEADLINE)
    rows = 4 // shape[0]
    for loss, grads, logits, data_rank in out:
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
        assert loss == pytest.approx(uloss, rel=1e-5, abs=1e-5)
        np.testing.assert_allclose(logits, ulogits[data_rank * rows:(data_rank + 1) * rows], **TOL)
        assert len(grads) == len(jgrads)
        for g, jg, ug in zip(grads, jgrads, ugrads):
            np.testing.assert_allclose(g, jg, **TOL)
            np.testing.assert_allclose(g, ug, **TOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_bodies_that_do_not_divide_the_model_axis_run_replicated(pool, jparams, jax_ref, shape):
    test_sharded_logits_loss_and_gradients_match_jax(pool, jparams, jax_ref, "deepseek-7b:odd", shape, "reference")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_sharded_train_step_matches_jax(pool, jparams, shape, microbatches):
    import jax
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    jcfg, jp = _jax_cfg("deepseek-7b"), jparams["deepseek-7b"][0]
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), microbatches=microbatches))
        jp2, _, jm = jfn(jp, jadamw.init_opt_state(jp), {k: jnp.asarray(v) for k, v in _batch().items()})
    want = _as_port(jp2, port_cfg("deepseek-7b"))
    for loss, gnorm, params in pool.run(task_step, "deepseek-7b", shape, jparams["deepseek-7b"][1], _batch(),
                                        microbatches, deadline=DEADLINE):
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        for t, j in zip(params, want):
            np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_tp_ffn_keeps_the_tensordash_path_on_every_rank(pool, jparams, shape):
    """Per rank and forward: one fused gate, one emitted plan and one
    planned ``w_down`` per layer (plus the LM head's planned product), each
    emitted plan over the rank's own ``d_ff / model`` columns and its local
    token rows: no plan of the gathered FFN.  The head's plan is keyed by
    the local shard: replayed where no FSDP gather makes a new tensor."""
    cfg = port_cfg("deepseek-7b")
    tp, layers = shape[1], cfg.num_layers
    tokens = 4 // shape[0] * 16
    for counts, cache in pool.run(task_plan_counts, shape, jparams["deepseek-7b"][1], _batch(),
                                  deadline=DEADLINE):
        assert counts["fused"] == layers
        assert counts["planned"] == layers + 1
        assert counts["emitted"] == [(tokens, cfg.d_ff // tp)] * layers
        # the head's side-B plan: rebuilt per forward under FSDP (a new
        # gathered tensor), replayed from the cache on a data axis of one
        assert cache == ({"entries": 1, "hits": 1, "misses": 1} if shape[0] == 1
                         else {"entries": 1, "hits": 0, "misses": 2})


def test_vocab_parallel_cross_entropy_matches_jax_on_gathered_logits(pool):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((24, 256)) * 3).astype(np.float32)
    labels = rng.integers(0, 256, 24).astype(np.int32)

    def jloss(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1)[:, 0]

    want = np.asarray(jloss(jnp.asarray(logits)))
    wgrad = np.asarray(jax.grad(lambda x: jnp.mean(jloss(x)))(jnp.asarray(logits)))
    out = pool.run(task_vocab_ce, logits, labels, deadline=DEADLINE)
    for r, (nll, grad) in enumerate(out):
        np.testing.assert_allclose(nll, want, **TOL)
        np.testing.assert_allclose(grad, wgrad[:, r * 64:(r + 1) * 64], rtol=1e-5, atol=1e-7)
    # one rank: the plain cross entropy
    one = S.vocab_parallel_ce(torch.from_numpy(logits), torch.from_numpy(labels), 0, None)
    np.testing.assert_allclose(one.numpy(), want, **TOL)
