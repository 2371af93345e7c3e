"""Head-parallel multi-head latent attention: reduced deepseek-v2 sharded on
4 CPU ranks, against the JAX package.

One pool of 4 spawned ranks (``repro_torch.parallel.rehearsal``) builds
``(data, model)`` meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``.  Each model
rank takes its ``num_heads / model`` heads: its whole heads' columns of
``wq_b`` and ``wkv_b`` and rows of ``wo`` (fp32 partials, one all-reduce);
``wq_a``/``wkv_a`` and their norms are whole on every rank, which computes
and caches the whole latent.  The MoE runs expert-parallel, the dense first
block tensor-parallel with its ReLU gate fused on the ``reference``
backend.  The JAX side runs in the test process under ``jax.jit`` with
``Runtime(sharding=ShardingPolicy(mesh=Mesh(devices[:4].reshape(shape),
("data", "model"))))``, once per mesh.

Model: reduced deepseek-v2-236b with a ReLU gate (4 heads, kv_lora_rank 32,
one dense and two MoE blocks of 8 experts top-2 and one shared expert),
``capacity_factor`` 8 (JAX's sharded MoE counts capacity per shard; at 8
nothing is dropped on either side) and a plain all-to-all payload
(``moe_a2a_quant`` off: an int8 value within rounding of a half step can
round to the other level in the two packages), fp32 parameters from the
JAX initializer, a ``[4, 16]`` batch.

* Logits, loss and every gradient within rtol = atol = 1e-5 of JAX's
  sharded loss; one ``make_train_step`` step within 1e-5 of JAX's sharded
  gradients through JAX's AdamW.
* On ``(2, 2)``: the engine's greedy tokens equal JAX's unsharded
  ``ServeEngine``; ``prefill`` and three ``decode_step`` logits (the
  absorbed decode on the local heads) within 1e-5 of JAX's, each step from
  JAX's caches, in fp32, cut as the engine cuts them.
* The latent cache is whole on every model rank, where the size rule of
  ``cache_pspecs`` (JAX's) would cut its last dim over ``model``.

The module imports no JAX at its top, so the ranks stay light.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.mla import MLACache
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep
from test_torch_sharded_model import _as_port, _jax_mesh, _numpy, _to_torch
from test_torch_sharded_ssm import BUDGETS, OPT, TOL, _leaf_shapes, _prompts

MESHES = [(2, 2), (1, 4), (4, 1)]
ARCH = "deepseek-v2-236b"
GEOM = dict(bm=8, bk=16, bn=16)
DEADLINE = 120.0
KW = dict(activation="relu", capacity_factor=8.0, moe_a2a_quant=False)


def port_cfg():
    return dataclasses.replace(reduce_config(get_config(ARCH)), **KW)


def _jax_cfg():
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return dataclasses.replace(jreduce_config(jget_config(ARCH)), **KW)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _setup(shape, params):
    cfg = port_cfg()
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    local = S.shard_tree(_to_torch(params), specs, policy)
    return cfg, policy, specs, local, Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)


def task_loss_grads(shape, params, batch):
    cfg, policy, specs, local, rt = _setup(shape, params)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use():
        sh = TT.shards_of(cfg)
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        with torch.no_grad():
            full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
            logits = TM.forward(local, cfg, tstep.local_batch(cfg, batch, sh))
    return float(loss), [x.numpy() for x in tadamw.tree_leaves(full)], logits.numpy(), sh.data_rank


def task_step(shape, params, batch):
    cfg, policy, specs, local, rt = _setup(shape, params)
    with rt.use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT))
        p2, _, m = fn(local, tstep.init_train_state(cfg, local), {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            full = S.gather_tree(p2, specs, policy)
    return float(m["loss"]), float(m["grad_norm"]), [x.detach().numpy() for x in tadamw.tree_leaves(full)]


def task_engine(shape, params, prompts):
    cfg, policy, _, local, _ = _setup(shape, params)
    eng = ServeEngine(local, cfg, slots=2, max_len=16, chunk=3,
                      rt=Runtime(backend="reference", device="cpu", sharding=policy, bm=2, bk=16, bn=16))
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    return eng.run(), _leaf_shapes(eng.caches)


def task_logits(params, prompts, steps):
    """On ``(2, 2)``: prefill logits of two 8-token prompts (this rank's
    data row) and its latent caches' shapes, then each decode step's logits
    from JAX's caches (fp32) cut as the engine cuts them (the row over
    ``data``, the latent whole)."""
    cfg, policy, _, local, rt = _setup((2, 2), params)
    sh = S.ModelShards(policy, None)
    row = slice(sh.data_rank, sh.data_rank + 1)
    toks = torch.from_numpy(np.stack([prompts[1], prompts[4]]))[row]
    out = []
    with rt.use(), torch.no_grad():
        logits, caches = TM.prefill(local, cfg, {"tokens": toks})
        out.append(logits.numpy())
        shapes = _leaf_shapes(caches)
        for i, (jcaches, tok) in enumerate(steps):
            glob = {stack: [MLACache(*(torch.from_numpy(a[l]) for a in c))
                            for l in range(c[0].shape[0])] for stack, c in jcaches.items()}
            specs = S.rank_cache_pspecs(glob, ("data",), TM.cache_splits(cfg, sh.tp))
            local_caches = S.map_specs(lambda x, sp: S.local_shard(x, sp, policy).clone(), glob, specs)
            logits, _ = TM.decode_step(local, cfg, local_caches, {"tokens": torch.from_numpy(tok[row, None])}, 8 + i)
            out.append(logits.numpy())
    return out, shapes, sh.data_rank


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jparams():
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    jp = jinit_params(JM.param_specs(_jax_cfg()), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), port_cfg()))


@pytest.fixture(scope="module")
def jax_ref(jparams):
    """JAX's sharded loss, gradients (the port's leaf order, and JAX's
    tree) and logits per mesh shape, each compiled once."""
    memo = {}

    def get(shape):
        if shape not in memo:
            import jax
            import jax.numpy as jnp

            from repro import runtime as jrt
            from repro.models import model as JM
            from repro.parallel.sharding import ShardingPolicy

            jcfg = _jax_cfg()
            batch = {k: jnp.asarray(v) for k, v in _batch().items()}
            fn = lambda p, b: (JM.loss_fn(p, jcfg, b), JM.forward(p, jcfg, b))
            with jrt.use(jrt.Runtime(backend="reference", sharding=ShardingPolicy(mesh=_jax_mesh(shape)), **GEOM)):
                (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jparams[0], batch)
            memo[shape] = float(loss), _as_port(grads, port_cfg()), np.asarray(logits), grads
        return memo[shape]

    return get


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_sharded_logits_loss_and_gradients_match_jax(pool, jparams, jax_ref, shape):
    jloss, jgrads, jlogits, _ = jax_ref(shape)
    rows = 4 // shape[0]
    for loss, grads, logits, data_rank in pool.run(task_loss_grads, shape, jparams[1], _batch(), deadline=DEADLINE):
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
        np.testing.assert_allclose(logits, jlogits[data_rank * rows:(data_rank + 1) * rows], **TOL)
        assert len(grads) == len(jgrads)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_sharded_train_step_matches_jax(pool, jparams, jax_ref, shape):
    import jax

    from repro.optim import adamw as jadamw

    jloss, _, _, jgrads = jax_ref(shape)
    jp2, _, jm = jax.jit(lambda p, g: jadamw.apply_updates(p, g, jadamw.init_opt_state(p),
                                                           jadamw.OptConfig(**OPT)))(jparams[0], jgrads)
    want = _as_port(jp2, port_cfg())
    for loss, gnorm, params in pool.run(task_step, shape, jparams[1], _batch(), deadline=DEADLINE):
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        for t, j in zip(params, want):
            np.testing.assert_allclose(t, j, **TOL)


def test_sharded_engine_greedy_tokens_match_jax_and_keep_the_latent_whole(pool, jparams):
    from repro import runtime as jrt
    from repro.serve.engine import ServeEngine as JServeEngine

    jp, tp = jparams
    prompts = _prompts()
    jeng = JServeEngine(jp, _jax_cfg(), slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", bm=2, bk=16, bn=16))
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
    want = jeng.run()
    cfg = port_cfg()
    for out, shapes in pool.run(task_engine, (2, 2), tp, prompts, deadline=DEADLINE):
        assert out == want
        assert [len(out[r]) for r in range(5)] == list(BUDGETS)
        # one slot a data rank, the latent and the rope key whole on each model rank
        assert shapes == {"c_kv": (1, 16, cfg.kv_lora_rank), "k_pe": (1, 16, cfg.qk_rope_head_dim)}


def test_sharded_prefill_and_decode_logits_match_jax(pool, jparams):
    import jax
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.models import model as JM

    jp, tp = jparams
    jcfg = _jax_cfg()
    prompts = _prompts()
    toks = jnp.asarray(np.stack([prompts[1], prompts[4]]))
    steps = []
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        logits, caches = JM.prefill(jp, jcfg, {"tokens": toks})
        want = [np.asarray(logits)]
        # fp32 latents: a step writes its new latent row into the cache, and
        # a rank's one-row products sum in another order than two rows do, so
        # a bf16 write can round a near-tie to the other bf16 value
        full = jax.tree.map(lambda x: x.astype(jnp.float32), jrt.resolve(None).grow_caches(jcfg, caches, 2, 16))
        tok = jnp.argmax(logits[:, -1], -1)
        for i in range(3):
            steps.append(({k: [np.asarray(x) for x in c] for k, c in full.items()},
                          np.asarray(tok, np.int64)))
            logits, full = JM.decode_step(jp, jcfg, full, {"tokens": tok[:, None]}, 8 + i)
            want.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], -1)
    cfg = port_cfg()
    for got, shapes, data_rank in pool.run(task_logits, tp, prompts, steps, deadline=DEADLINE):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[data_rank:data_rank + 1], **TOL)
        assert shapes == {"c_kv": (1, 8, cfg.kv_lora_rank), "k_pe": (1, 8, cfg.qk_rope_head_dim)}


@pytest.mark.parametrize("tp", [2, 4])
def test_latent_cache_stays_whole_where_the_size_rule_would_cut_it(tp):
    """``cache_pspecs``, the JAX package's size rule, cuts the first dim
    after the batch that divides ``model``: the latent's last dim (32) at
    ``model`` 2 and 4.  Every model rank computes the whole latent, so the
    port's layouts keep it whole; the slots still split over ``data``."""
    cfg = port_cfg()
    glob = TM.init_cache(cfg, 2, 16, device="meta")
    duck = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": tp})
    size_rule = S.cache_pspecs(cfg, S.BatchShape(2, 16, "decode"), duck, glob)
    assert size_rule["layers"][0].c_kv == ("data", None, "model")
    assert TM.cache_splits(cfg, tp) == frozenset()
    ours = S.rank_cache_pspecs(glob, ("data",), TM.cache_splits(cfg, tp))
    for stack in ("dense_layers", "layers"):
        for c in ours[stack]:
            assert c == MLACache(("data", None, None), ("data", None, None))
