"""Tensor-parallel Mamba2 and the sharded hybrid on 4 CPU ranks, against the
JAX package.

One pool of 4 spawned ranks (``repro_torch.parallel.rehearsal``) builds
``(data, model)`` meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``; every rank
holds the ``local_shard`` of every parameter under ``param_pspecs`` (the
Mamba2 heads over ``model``: ``in_z``/``in_x``/``in_dt``, the ``conv_x``
channels, ``dt_bias``/``a_log``/``d_skip``/``norm_w`` and the rows of
``out_proj``; ``in_b``/``in_c`` and the B/C convs whole) and runs the
sharded model.  The JAX side runs in the test process under ``jax.jit``
with ``Runtime(sharding=ShardingPolicy(mesh=Mesh(devices[:4].reshape(
shape), ("data", "model"))))``, once per (arch, mesh): its loss, gradients
and logits.

Models: reduced mamba2-780m (8 heads of 16) and reduced zamba2-2.7b (its
shared block 4 heads over 2 kv heads, so ``(1, 4)`` replicates K/V), fp32
parameters from the JAX initializer, a ``[4, 16]`` batch.

* Logits, loss and every gradient within rtol = atol = 1e-5 of JAX's
  sharded loss; one ``make_train_step`` step within 1e-5 of JAX's sharded
  gradients through JAX's AdamW.
* On ``(2, 2)``: the engine's greedy tokens equal JAX's unsharded
  ``ServeEngine`` (both packages' conv tails fp32, the one layout JAX's
  engine carries for an fp32 model, as ``tests/test_torch_serve.py``
  patches them); ``prefill`` and three ``decode_step`` logits within 1e-5
  of JAX's, each step from JAX's caches cut as the engine cuts them; the
  SSM states and ``conv_x`` split over ``model``, ``conv_b``/``conv_c``
  whole.
* The gated norm's sum of squares summed over ``model`` both ways: forward
  and ``torch.autograd`` gradients against the unsharded ``rms_norm``.
* Three slots (a conv tail's ``W - 1`` rows): the cache layout by leaf, not
  by size, and the same tokens as the unsharded engine.
* A Mamba2 body of 6 heads runs split on ``(2, 2)`` and replicated on
  ``(1, 4)``: loss and gradients equal the unsharded model's.

The module imports no JAX at its top, so the ranks stay light.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import hybrid as TH
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.attention import KVCache
from repro_torch.models.common import init_params, rms_norm, silu
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep
from test_torch_sharded_model import _as_port, _jax_mesh, _numpy, _to_torch

MESHES = [(2, 2), (1, 4), (4, 1)]
ARCHS = ["mamba2-780m", "zamba2-2.7b"]
GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
#: AdamW's eps as ``tests/test_torch_sharded_model.py`` sets it (see there)
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-6)
PLENS = (5, 8, 3, 5, 8)
BUDGETS = (4, 2, 5, 3, 4)
DEADLINE = 120.0
#: a reduced mamba2 whose 6 heads divide a model axis of 2 but not of 4
ODD = dict(d_model=48)


def port_cfg(arch):
    base, _, odd = arch.partition(":")
    cfg = reduce_config(get_config(base))
    return dataclasses.replace(cfg, **ODD) if odd else cfg


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    return jreduce_config(jget_config(arch))


def _batch(vocab=256, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, vocab, (4, 16)).astype(np.int32)}


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in PLENS]


@contextlib.contextmanager
def fp32_conv_tails():
    """The port's SSM decode caches with fp32 conv tails (JAX's engine runs
    an fp32 model only on those; ``tests/test_torch_serve.py``)."""
    init = TS.init_ssm_cache
    TS.init_ssm_cache = functools.partial(init, dtype=torch.float32)
    try:
        yield
    finally:
        TS.init_ssm_cache = init


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _setup(arch, shape, params, backend="reference"):
    cfg = port_cfg(arch)
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    local = S.shard_tree(_to_torch(params), specs, policy)
    return cfg, policy, specs, local, Runtime(backend=backend, device="cpu", sharding=policy, **GEOM)


def task_loss_grads(arch, shape, params, batch):
    """Loss, the gathered gradients (``tree_leaves`` order), this rank's
    logits rows and its data rank."""
    cfg, policy, specs, local, rt = _setup(arch, shape, params)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use():
        sh = TT.shards_of(cfg)
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        with torch.no_grad():
            full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
            logits = TM.forward(local, cfg, tstep.local_batch(cfg, batch, sh))
    return float(loss), [x.numpy() for x in tadamw.tree_leaves(full)], logits.numpy(), sh.data_rank


def task_step(arch, shape, params, batch):
    cfg, policy, specs, local, rt = _setup(arch, shape, params)
    with rt.use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT))
        p2, _, m = fn(local, tstep.init_train_state(cfg, local), {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            full = S.gather_tree(p2, specs, policy)
    return float(m["loss"]), float(m["grad_norm"]), [x.detach().numpy() for x in tadamw.tree_leaves(full)]


def _leaf_shapes(tree) -> dict:
    """``{field: shape}`` of the first cache named tuple of each kind."""
    out = {}

    def walk(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            if all(isinstance(x, torch.Tensor) or x is None for x in t):
                for f, x in zip(t._fields, t):
                    if x is not None:
                        out.setdefault(f, tuple(x.shape))
                return
            for x in t:
                walk(x)
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif isinstance(t, dict):
            for x in t.values():
                walk(x)

    walk(tree)
    return out


def task_engine(arch, shape, params, prompts, slots, fp32_tails):
    """The sharded engine's tokens and its caches' leaf shapes."""
    cfg, policy, _, local, _ = _setup(arch, shape, params)
    rt = Runtime(backend="reference", device="cpu", sharding=policy, bm=2, bk=16, bn=16)
    with fp32_conv_tails() if fp32_tails else contextlib.nullcontext():
        eng = ServeEngine(local, cfg, slots=slots, max_len=16, chunk=3, rt=rt)
        for p, n in zip(prompts, BUDGETS):
            eng.submit(torch.from_numpy(p), max_new=n)
        out = eng.run()
    return out, _leaf_shapes(eng.caches)


def task_logits(arch, params, prompts, steps):
    """On ``(2, 2)``: prefill logits of two 8-token prompts (this rank's
    data row) and its caches' shapes, then each decode step's logits from
    JAX's caches (``(array, is_bf16)`` leaves) cut as the engine cuts them."""
    cfg, policy, _, local, rt = _setup(arch, (2, 2), params)
    sh = S.ModelShards(policy, None)
    row = slice(sh.data_rank, sh.data_rank + 1)
    toks = torch.from_numpy(np.stack([prompts[1], prompts[4]]))[row]
    specs = None
    out = []
    with rt.use(), torch.no_grad():
        logits, caches = TM.prefill(local, cfg, {"tokens": toks})
        out.append(logits.numpy())
        shapes = _leaf_shapes(caches)
        for i, (jcaches, tok) in enumerate(steps):
            glob = _from_jax_caches(cfg, jcaches)
            if specs is None:
                specs = S.rank_cache_pspecs(glob, ("data",), TM.cache_splits(cfg, sh.tp))
            local_caches = S.map_specs(lambda x, sp: S.local_shard(x, sp, policy).clone(), glob, specs)
            logits, _ = TM.decode_step(local, cfg, local_caches, {"tokens": torch.from_numpy(tok[row, None])}, 8 + i)
            out.append(logits.numpy())
    return out, shapes, sh.data_rank


def _from_jax_caches(cfg, jc):
    """JAX's stacked decode caches (``(float32 array, was bf16)`` leaves)
    as the port's per-layer ones, in JAX's dtypes."""
    t = lambda x: torch.from_numpy(x[0]).to(torch.bfloat16 if x[1] else torch.float32)
    if cfg.family == "ssm":
        return [TS.SSMCache(*(t((f[0][l], f[1])) for f in jc)) for l in range(cfg.num_layers)]
    ssm, (k, v) = jc
    groups = ssm[0][0].shape[0]
    return TH.HybridCache(
        ssm=[[TS.SSMCache(*(t((f[0][g, a], f[1])) for f in ssm)) for a in range(cfg.attn_every)]
             for g in range(groups)],
        kv=[KVCache(k=t((k[0][g], k[1])), v=t((v[0][g], v[1]))) for g in range(groups)])


def task_gated_norm(y, z, w, gy):
    """``_gated_norm`` of this rank's channels on a ``(1, 4)`` mesh, and
    the gradients of ``sum(out * gy)`` on its slices."""
    sh = S.ModelShards(S.ShardingPolicy(mesh=mesh((1, 4), ("data", "model"))), None)
    c = y.shape[-1] // sh.tp
    cut = lambda a: torch.from_numpy(a[..., sh.tp_rank * c:(sh.tp_rank + 1) * c].copy()).requires_grad_()
    ys, zs, ws = cut(y), cut(z), cut(w)
    out = TS._gated_norm(ys, zs, ws, lambda ss: S.tp_sum(ss, sh.model_group), y.shape[-1])
    grads = torch.autograd.grad((out * cut(gy).detach()).sum(), [ys, zs, ws])
    return out.detach().numpy(), [g.numpy() for g in grads], sh.tp_rank


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
    for arch in ARCHS:
        jp = jinit_params(JM.param_specs(_jax_cfg(arch)), jax.random.PRNGKey(0), dtype=jnp.float32)
        out[arch] = jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(arch)))
    return out


@pytest.fixture(scope="module")
def jax_ref(jparams):
    """JAX's sharded loss, gradients (the port's leaf order, and JAX's
    tree) and logits per (arch, mesh shape), each compiled once."""
    memo = {}

    def get(arch, shape):
        if (arch, shape) not in memo:
            import jax
            import jax.numpy as jnp

            from repro import runtime as jrt
            from repro.models import model as JM
            from repro.parallel.sharding import ShardingPolicy

            jcfg, jp = _jax_cfg(arch), jparams[arch][0]
            batch = {k: jnp.asarray(v) for k, v in _batch().items()}
            fn = lambda p, b: (JM.loss_fn(p, jcfg, b), JM.forward(p, jcfg, b))
            with jrt.use(jrt.Runtime(backend="reference", sharding=ShardingPolicy(mesh=_jax_mesh(shape)), **GEOM)):
                (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(jp, batch)
            memo[arch, shape] = float(loss), _as_port(grads, port_cfg(arch)), np.asarray(logits), grads
        return memo[arch, shape]

    return get


@pytest.fixture(scope="module")
def jax_adamw():
    """JAX's AdamW step from fresh moments, jitted once per tree layout
    (eager, its per-leaf ops compile one by one)."""
    import jax

    from repro.optim import adamw as jadamw

    fn = jax.jit(lambda p, g: jadamw.apply_updates(p, g, jadamw.init_opt_state(p), jadamw.OptConfig(**OPT)))

    def step(jp, jgrads):
        jp2, _, jm = fn(jp, jgrads)
        return jp2, jm

    return step


@contextlib.contextmanager
def _jax_fp32_tails():
    from repro.models import ssm as jssm
    import jax.numpy as jnp

    init = jssm.init_ssm_cache
    jssm.init_ssm_cache = functools.partial(init, dtype=jnp.float32)
    try:
        yield
    finally:
        jssm.init_ssm_cache = init


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_loss_and_gradients_match_jax(pool, jparams, jax_ref, arch, shape):
    jloss, jgrads, jlogits, _ = jax_ref(arch, shape)
    rows = 4 // shape[0]
    out = pool.run(task_loss_grads, arch, shape, jparams[arch][1], _batch(), deadline=DEADLINE)
    for loss, grads, logits, data_rank in out:
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
        np.testing.assert_allclose(logits, jlogits[data_rank * rows:(data_rank + 1) * rows], **TOL)
        assert len(grads) == len(jgrads)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax(pool, jparams, jax_ref, jax_adamw, arch, shape):
    jloss, _, _, jgrads = jax_ref(arch, shape)
    jp2, jm = jax_adamw(jparams[arch][0], jgrads)
    want = _as_port(jp2, port_cfg(arch))
    for loss, gnorm, params in pool.run(task_step, arch, shape, jparams[arch][1], _batch(), deadline=DEADLINE):
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        for t, j in zip(params, want):
            np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_greedy_tokens_match_jax(pool, jparams, arch):
    from repro import runtime as jrt
    from repro.serve.engine import ServeEngine as JServeEngine

    jp, tp = jparams[arch]
    prompts = _prompts()
    with _jax_fp32_tails():
        jeng = JServeEngine(jp, _jax_cfg(arch), slots=2, max_len=16, chunk=3,
                            rt=jrt.Runtime(backend="reference", bm=2, bk=16, bn=16))
        for p, n in zip(prompts, BUDGETS):
            jeng.submit(p, max_new=n)
        want = jeng.run()
    cfg = port_cfg(arch)
    di, gn = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    heads = di // cfg.ssm_headdim
    for out, shapes in pool.run(task_engine, arch, (2, 2), tp, prompts, 2, True, deadline=DEADLINE):
        assert out == want
        assert [len(out[r]) for r in range(5)] == list(BUDGETS)
        # one slot a data rank; the heads' conv channels and states split over
        # model, B and C's tails whole
        assert shapes["conv_x"] == (1, 3, di // 2) and shapes["state"] == (1, heads // 2, 16, gn)
        assert shapes["conv_b"] == shapes["conv_c"] == (1, 3, gn)
        if cfg.family == "hybrid":  # the shared block's kv heads split over model
            assert shapes["k"] == (1, 16, cfg.shared_attn_kv_heads // 2, cfg.d_model // cfg.shared_attn_heads)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_logits_match_jax(pool, jparams, arch):
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.models import model as JM

    jp, tp = jparams[arch]
    jcfg = _jax_cfg(arch)
    prompts = _prompts()
    toks = jnp.asarray(np.stack([prompts[1], prompts[4]]))
    leaf = lambda x: (np.asarray(x, np.float32), x.dtype == jnp.bfloat16)
    steps = []
    with _jax_fp32_tails(), jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        logits, caches = JM.prefill(jp, jcfg, {"tokens": toks})
        want = [np.asarray(logits)]
        full = jrt.resolve(None).grow_caches(jcfg, caches, 2, 16)
        tok = jnp.argmax(logits[:, -1], -1)
        for i in range(3):
            if jcfg.family == "ssm":
                steps.append(([leaf(x) for x in full], np.asarray(tok, np.int64)))
            else:
                steps.append((([leaf(x) for x in full.ssm], (leaf(full.kv.k), leaf(full.kv.v))),
                              np.asarray(tok, np.int64)))
            logits, full = JM.decode_step(jp, jcfg, full, {"tokens": tok[:, None]}, 8 + i)
            want.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], -1)
    cfg = port_cfg(arch)
    di = cfg.ssm_expand * cfg.d_model
    for got, shapes, data_rank in pool.run(task_logits, arch, tp, prompts, steps, deadline=DEADLINE):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[data_rank:data_rank + 1], **TOL)
        # the prefill caches the local steps return: this rank's heads
        assert shapes["conv_x"] == (1, 3, di // 2) and shapes["state"][1] == di // cfg.ssm_headdim // 2


def test_gated_norm_sums_its_statistic_over_model_both_ways(pool):
    rng = np.random.default_rng(11)
    y, z, w, gy = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(4))
    w = w[0, 0]
    ty, tz, tw = (torch.from_numpy(a).requires_grad_() for a in (y, z, w))
    want = rms_norm(ty * silu(tz), tw)
    wgrads = torch.autograd.grad((want * torch.from_numpy(gy)).sum(), [ty, tz, tw])
    out = pool.run(task_gated_norm, y, z, w, gy, deadline=DEADLINE)
    out.sort(key=lambda r: r[2])
    np.testing.assert_allclose(np.concatenate([o for o, _, _ in out], -1), want.detach().numpy(), **TOL)
    for i, wg in enumerate(wgrads):
        np.testing.assert_allclose(np.concatenate([g[i] for _, g, _ in out], -1), wg.numpy(), **TOL)
    # without the backward sum each rank's gradient of y would miss the other
    # ranks' share of the statistic: the test above would fail
    ys = torch.from_numpy(y[..., :8].copy()).requires_grad_()
    alone = rms_norm(ys * silu(torch.from_numpy(z[..., :8])), torch.from_numpy(w[:8]))
    g_alone, = torch.autograd.grad((alone * torch.from_numpy(gy[..., :8])).sum(), [ys])
    assert not np.allclose(g_alone.numpy(), wgrads[0].numpy()[..., :8], **TOL)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_conv_tail_rows_equal_to_the_slots_keep_their_layout(pool, jparams, shape):
    """Three slots, as many as a conv tail's ``W - 1`` rows: each leaf is
    cut by its layout (the slots whole, as 3 do not divide the data axis
    of 2; ``conv_x``/``state`` by heads over ``model``), and the tokens equal
    the unsharded port engine's."""
    arch = "mamba2-780m"
    cfg = port_cfg(arch)
    prompts = _prompts()
    eng = ServeEngine(_to_torch(jparams[arch][1]), cfg, slots=3, max_len=16, chunk=3,
                      rt=Runtime(backend="reference", device="cpu", bm=2, bk=16, bn=16))
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    want = eng.run()
    assert cfg.conv_width - 1 == 3
    tp = shape[1]
    di, heads = cfg.ssm_expand * cfg.d_model, cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    for out, shapes in pool.run(task_engine, arch, shape, jparams[arch][1], prompts, 3, False, deadline=DEADLINE):
        assert out == want
        assert shapes == {"conv_x": (3, 3, di // tp), "conv_b": (3, 3, cfg.ssm_state),
                          "conv_c": (3, 3, cfg.ssm_state), "state": (3, heads // tp, 16, cfg.ssm_state)}


def task_odd(shape, params, batch):
    cfg, policy, specs, local, rt = _setup("mamba2-780m:odd", shape, params)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use():
        sh = TT.shards_of(cfg)
        w, lcfg, group = TS.ssm_local(local["layers"][0]["ssm"], sh.specs["layers"][0]["ssm"],
                                      TH.ssm_config(cfg), sh)
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
    return float(loss), [x.numpy() for x in tadamw.tree_leaves(full)], lcfg.num_heads, group is None


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_heads_that_do_not_divide_the_model_axis_run_replicated(pool, shape):
    cfg = port_cfg("mamba2-780m:odd")
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    assert heads == 6
    params = init_params(TM.param_specs(cfg), seed=2, dtype=torch.float32, device="cpu")
    whole = _numpy(params)
    batch = _batch()
    with Runtime(backend="reference", device="cpu", **GEOM).use():
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, params,
                                                {k: torch.from_numpy(v) for k, v in batch.items()})
    for tloss, tgrads, local_heads, replicated in pool.run(task_odd, shape, whole, batch,
                                                           deadline=DEADLINE):
        assert (local_heads, replicated) == ((3, False) if shape[1] == 2 else (6, True))
        assert tloss == pytest.approx(float(loss), rel=1e-5, abs=1e-5)
        for g, u in zip(tgrads, grads):
            np.testing.assert_allclose(g, u.numpy(), **TOL)


def test_a_head_slice_splits_k_as_the_whole_heads_launch(monkeypatch):
    """mamba2's vocab (50280) fits lanes of 120, a quarter of it (12570) only
    30: a vocab-parallel slice's launch carries the whole head's shape and
    the blocks the runtime fits to it, so the kernel cuts K into the shares
    of the whole head's launch (bit-equal on the card, where a split count
    taken at the slice's own blocks differs)."""
    from repro_torch.runtime import backends

    seen = []

    def spy(nnz, idx, a, b, **kw):
        seen.append((kw["bm"], kw["split_shape"]))
        return torch.zeros(a.shape[0], b.shape[1])

    monkeypatch.setattr(backends.CudaBackend, "_check", lambda self, r: None)
    monkeypatch.setattr(backends, "tensordash_matmul_planned", spy)
    cfg = get_config("mamba2-780m")
    d, v = 16, cfg.vocab_size
    lm_head = torch.randn(d, v)
    h = torch.randn(4, 1, d)
    with Runtime(backend="cuda", device="cpu").use():
        for r in range(4):
            w = lm_head[:, r * v // 4:(r + 1) * v // 4]
            TT.head_matmul(cfg, h, w, key=("lm_head", r), vocab=v)
    assert seen == [(30, (v, d, 4, 120, d, 4))] * 4
