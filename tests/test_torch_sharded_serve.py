"""The serve engine on a ``(data 2, model 2)`` mesh of 4 CPU ranks, against
the JAX package's unsharded engine.

One pool of 4 spawned ranks (``repro_torch.parallel.rehearsal``); every rank
holds its shards of reduced deepseek-7b with a ReLU gate (fp32 parameters
from the JAX initializer) and runs the same scheduler on the same requests.
The two slots split over ``data`` (each data rank holds one slot's caches,
its KV heads split over ``model``), and every rank emits the same tokens:

* five requests of mixed prompt lengths and budgets through 2 slots (the
  engine's continuous batching, backfill included): greedy tokens equal to
  JAX's ``ServeEngine`` on the ``reference`` backend, request for request,
  on both port backends; ``generate(mesh=...)`` equal to JAX's
  ``generate``; sampled at temperature 0.8, JAX's sampled tokens on every
  rank (each rank samples the gathered rows from its replicated keys);
* each data rank prefills only the prompts of the slot it holds;
* ``prefill`` and three ``decode_step`` logits of the sharded model within
  rtol = atol = 1e-5 of JAX's unsharded ``prefill``/``decode_step``, each
  step from JAX's caches cut as the engine cuts them (bf16 caches: a
  near-tie can round to another bf16 value in each package's own);
* ``cuda_graph=True`` on a mesh of several ranks refused at construction.

The module imports no JAX at its top, so the ranks stay light.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.serve.engine import ServeEngine, generate

MESH = ((2, 2), ("data", "model"))
GEOM = dict(bm=2, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
PLENS = (5, 8, 3, 5, 8)
BUDGETS = (4, 2, 5, 3, 4)
DEADLINE = 120.0


def port_cfg():
    return dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")


def _jax_cfg():
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return dataclasses.replace(jreduce_config(jget_config("deepseek-7b")), activation="relu")


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in PLENS]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _local(params):
    cfg = port_cfg()
    policy = S.ShardingPolicy(mesh=mesh(*MESH))
    local = S.shard_tree(_to_torch(params), policy.param_pspecs(TM.param_specs(cfg)), policy)
    return cfg, policy, local


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def task_engine(params, prompts, backend):
    """The engine's tokens, its cache shapes, ``generate``'s tokens, and the
    rows of each prefill this rank ran in the engine (a hook on
    ``models.model.prefill``) with its data rank."""
    cfg, policy, local = _local(params)
    rt = Runtime(backend=backend, device="cpu", sharding=policy, **GEOM)
    eng = ServeEngine(local, cfg, slots=2, max_len=16, chunk=3, rt=rt)
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    rows, prefill = [], TM.prefill
    TM.prefill = lambda p, c, batch: rows.append(batch["tokens"].shape[0]) or prefill(p, c, batch)
    try:
        out = eng.run()
    finally:
        TM.prefill = prefill
    caches = [tuple(x.shape) for x in eng.caches["layers"][0][:2]]
    gen = generate(local, cfg, torch.from_numpy(np.stack([prompts[1], prompts[4]])), max_new=4,
                   rt=Runtime(backend=backend, device="cpu", **GEOM), mesh=policy.mesh)
    return out, caches, gen.tolist(), rows, S.ModelShards(policy, None).data_rank


def task_engine_sampled(params, prompts, temperature, seed):
    """The engine's tokens at ``temperature`` on the ``reference`` backend."""
    cfg, policy, local = _local(params)
    rt = Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)
    eng = ServeEngine(local, cfg, slots=2, max_len=16, chunk=3, rt=rt, temperature=temperature, seed=seed)
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    return eng.run()


def task_logits(params, prompts, steps):
    """Prefill logits of two 8-token prompts (this rank's data row), then
    each decode step's logits from the given caches (the JAX package's: in
    bf16 a value at a near-tie can round to another bf16 value in each
    package's own caches), cut as the engine cuts them: the row over
    ``data``, the KV heads over ``model``."""
    from repro_torch.models.attention import KVCache

    cfg, policy, local = _local(params)
    rt = Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)
    sh = S.ModelShards(policy, None)
    toks = torch.from_numpy(np.stack([prompts[1], prompts[4]]))[sh.data_rank:sh.data_rank + 1]
    spec = ("data", None, "model", None)
    cut = lambda a: S.local_shard(torch.from_numpy(a), spec, policy).to(torch.bfloat16)
    out = []
    with rt.use(), torch.no_grad():
        logits, _ = TM.prefill(local, cfg, {"tokens": toks})
        out.append(logits.numpy())
        for i, (caches, tok) in enumerate(steps):
            local_caches = {"layers": [KVCache(k=cut(k), v=cut(v)) for k, v in caches]}
            logits, _ = TM.decode_step(local, cfg, local_caches,
                                       {"tokens": torch.from_numpy(tok[sh.data_rank:sh.data_rank + 1, None])},
                                       8 + i)
            out.append(logits.numpy())
    return out, sh.data_rank


def task_graph_refused(params):
    cfg, policy, local = _local(params)
    try:
        ServeEngine(local, cfg, slots=2, max_len=16, cuda_graph=True,
                    rt=Runtime(backend="reference", device="cpu", sharding=policy, **GEOM))
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def model():
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    jp = jinit_params(JM.param_specs(_jax_cfg()), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), port_cfg())
    return jp, _numpy(tp)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("backend", ["reference", "dense"])
def test_sharded_engine_greedy_tokens_match_jax(pool, model, backend):
    from repro import runtime as jrt
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro.serve.engine import generate as jgenerate

    jp, tp = model
    prompts = _prompts()
    jeng = JServeEngine(jp, _jax_cfg(), slots=2, max_len=16, chunk=3, rt=jrt.Runtime(backend="reference", **GEOM))
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
    want = jeng.run()
    jgen = np.asarray(jgenerate(jp, _jax_cfg(), np.stack([prompts[1], prompts[4]]), max_new=4,
                                rt=jrt.Runtime(backend="reference", **GEOM))).tolist()
    cfg = port_cfg()
    outs = pool.run(task_engine, tp, prompts, backend, deadline=DEADLINE)
    for out, caches, gen, _, _ in outs:
        assert out == want
        assert [len(out[r]) for r in range(5)] == list(BUDGETS)
        # one slot a data rank, half the kv heads a model rank: cache_pspecs' cut
        assert caches == [(1, 16, cfg.num_kv_heads // 2, cfg.resolved_head_dim)] * 2
        assert gen == jgen
    # a data rank prefills only the prompts of its own slot, one row a call:
    # as many calls as the data rank with the most admissions (the other
    # runs a stand-in row), never the 5 prompts every rank would prefill
    rows = {data_rank: r for _, _, _, r, data_rank in outs}
    assert rows[0] == rows[1] and set(rows[0]) == {1}
    assert 3 <= len(rows[0]) < len(PLENS)


def test_sharded_engine_sampled_tokens_match_jax(pool, model):
    from repro import runtime as jrt
    from repro.serve.engine import ServeEngine as JServeEngine

    jp, tp = model
    prompts = _prompts()
    jeng = JServeEngine(jp, _jax_cfg(), slots=2, max_len=16, chunk=3, temperature=0.8, seed=5,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
    want = jeng.run()
    for out in pool.run(task_engine_sampled, tp, prompts, 0.8, 5, deadline=DEADLINE):
        assert out == want


def test_sharded_prefill_and_decode_logits_match_jax(pool, model):
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.models import model as JM

    jp, tp = model
    prompts = _prompts()
    jcfg = _jax_cfg()
    toks = jnp.asarray(np.stack([prompts[1], prompts[4]]))
    steps = []
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        logits, caches = JM.prefill(jp, jcfg, {"tokens": toks})
        want = [np.asarray(logits)]
        full = jrt.resolve(None).grow_caches(jcfg, caches, 2, 16)
        tok = jnp.argmax(logits[:, -1], -1)
        for i in range(3):
            kv = full["layers"]
            steps.append(([(np.asarray(kv.k[l], np.float32), np.asarray(kv.v[l], np.float32))
                           for l in range(kv.k.shape[0])], np.asarray(tok, np.int64)))
            logits, full = JM.decode_step(jp, jcfg, full, {"tokens": tok[:, None]}, 8 + i)
            want.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], -1)
    for got, data_rank in pool.run(task_logits, tp, prompts, steps, deadline=DEADLINE):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[data_rank:data_rank + 1], **TOL)


def test_cuda_graph_on_a_mesh_of_several_ranks_is_refused(pool, model):
    for msg in pool.run(task_graph_refused, model[1], deadline=DEADLINE):
        assert msg is not None and "mesh of 4 ranks" in msg
