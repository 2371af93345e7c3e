"""The frontends sharded on 4 CPU ranks: reduced qwen2-vl-72b (ReLU, M-RoPE)
and musicgen-large (the audio frontend's ``K`` codebook heads).

One pool of 4 spawned ranks (``repro_torch.parallel.rehearsal``) builds
``(data, model)`` meshes ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``.  A batch's
``inputs_embeds``, its M-RoPE ``positions [B, 3, S]`` (an image grid, so
the three streams differ) and the audio labels ``[B, S, K]`` are cut over
``data`` by ``batch_pspecs``; the audio head ``[K, d, v]`` is vocab-parallel
on its last axis and the cross entropy runs over its ``B * S * K`` rows.

JAX refuses fp32 parameters with a frontend (its scanned layers cannot
carry the bf16 embeddings into fp32 blocks), so there are two checks:

* fp32 parameters (the JAX initializer's): the sharded loss and every
  gradient within rtol = atol = 1e-5 of the port's own unsharded path
  (which ``tests/test_torch_frontends.py`` holds to JAX), one
  ``make_train_step`` step at two microbatches too.  One leaf is held to
  a bf16 bound instead: the first block's ``ln1``, whose gradient reaches
  it through the bf16 rounding of the first attention input's gradient
  (the frontend's bf16 embeddings make that input bf16), and the ranks'
  head slices sum that gradient in another order than one rank does, so a
  near-tie can round to the other bf16 value;
* bf16 parameters: the sharded loss against JAX's sharded loss under
  ``jax.jit`` on ``Mesh(devices[:4].reshape(shape), ("data", "model"))``,
  within the bf16 bound of ``tests/test_torch_model.py`` (atol 0.1).

What stays refused on a mesh of several ranks: a frontend in the engine and
in the train launcher, ``cuda_graph=True``; dynamic sparse training is no
longer refused (``tests/test_torch_sharded_dst.py``).

The module imports no JAX at its top, so the ranks stay light.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep
from test_torch_launch_mesh import _paths
from test_torch_sharded_model import _jax_mesh, _numpy, _to_torch

MESHES = [(2, 2), (1, 4), (4, 1)]
#: model name -> (arch, activation)
MODELS = {"qwen2-vl-relu": ("qwen2-vl-72b", "relu"), "musicgen-gelu": ("musicgen-large", "gelu")}
GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
#: the bf16 bound of ``tests/test_torch_model.py`` (``TOL["bfloat16"]``)
BF16 = dict(rtol=0.0, atol=0.1)
#: the first block's ``ln1`` gradient: within one bf16 step (2^-8
#: relative) of its largest entry, the rounding the module docstring names
LN1_STEP = 2.0**-7
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-6)
B, SEQ = 4, 24
DEADLINE = 120.0


def port_cfg(name):
    arch, act = MODELS[name]
    return dataclasses.replace(reduce_config(get_config(arch)), activation=act)


def _jax_cfg(name):
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    arch, act = MODELS[name]
    return dataclasses.replace(jreduce_config(jget_config(arch)), activation=act)


def _batch(cfg, seed=5):
    """numpy inputs: ``inputs_embeds``, an image grid's M-RoPE ``positions``
    (``tests/test_torch_frontends.py``'s), labels (``[B, S, K]`` under the
    audio frontend)."""
    from test_torch_frontends import image_positions

    rng = np.random.default_rng(seed)
    out = {"inputs_embeds": rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)}
    if cfg.mrope_sections is not None:
        out["positions"] = image_positions(B, SEQ)
    shape = (B, SEQ, cfg.num_codebooks) if cfg.frontend == "audio" else (B, SEQ)
    out["labels"] = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _setup(name, shape, params, dtype=torch.float32):
    cfg = port_cfg(name)
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")))
    specs = policy.param_pspecs(TM.param_specs(cfg))
    local = S.shard_tree(S.map_specs(lambda x, sp: x.to(dtype), _to_torch(params), specs), specs, policy)
    return cfg, policy, specs, local, Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)


def task_loss_grads(name, shape, params, batch):
    """Loss, the gathered gradients (``tree_leaves`` order), this rank's
    cut of the batch and its data rank, the ``lm_head`` slice's shape."""
    cfg, policy, specs, local, rt = _setup(name, shape, params)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use():
        sh = TT.shards_of(cfg)
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, local, batch, shards=sh)
        full = S.gather_tree(tstep.tree_unflatten(local, grads), specs, policy)
        cut = tstep.local_batch(cfg, batch, sh)
    return (float(loss), [x.numpy() for x in tadamw.tree_leaves(full)], {k: v.numpy() for k, v in cut.items()},
            sh.data_rank, tuple(local["lm_head"].shape))


def task_bf16_loss(name, shape, params, batch):
    cfg, _, _, local, rt = _setup(name, shape, params, torch.bfloat16)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with rt.use(), torch.no_grad():
        return float(TM.loss_fn(local, cfg, tstep.local_batch(cfg, batch, TT.shards_of(cfg))))


def task_step(name, shape, params, batch, microbatches):
    cfg, policy, specs, local, rt = _setup(name, shape, params)
    with rt.use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT), microbatches=microbatches)
        p2, _, m = fn(local, tstep.init_train_state(cfg, local), {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            full = S.gather_tree(p2, specs, policy)
    return float(m["loss"]), [x.detach().numpy() for x in tadamw.tree_leaves(full)]


def _raised(fn) -> str | None:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def task_refusals(params_vl, params_ssm):
    """What a mesh of 4 ranks still refuses, each call's error."""
    cfg, policy, _, local, rt = _setup("qwen2-vl-relu", (2, 2), params_vl)
    out = {"engine frontend": _raised(lambda: ServeEngine(local, cfg, slots=2, max_len=16, rt=rt))}
    buf = io.StringIO()
    swap = tlaunch.make_local_mesh
    tlaunch.make_local_mesh = lambda: mesh((2, 2), ("data", "model"))
    try:
        with contextlib.redirect_stdout(buf):
            out["launcher frontend"] = _raised(lambda: tlaunch.main(
                ["--smoke", "--device", "cpu", "--backend", "reference", "--steps", "1", "--seq", "16", "--batch",
                 "4", "--arch", "qwen2-vl-72b"]))
    finally:
        tlaunch.make_local_mesh = swap
    scfg = reduce_config(get_config("mamba2-780m"))
    sspecs = policy.param_pspecs(TM.param_specs(scfg))
    slocal = S.shard_tree(_to_torch(params_ssm), sspecs, policy)
    with rt.use():
        out["dst"] = _raised(lambda: tstep.make_train_step(scfg, tadamw.OptConfig(),
                                                           dynamic_sparsity={"layers.0.ssm.in_z": (16, 16)}))
    out["cuda graph"] = _raised(lambda: ServeEngine(slocal, scfg, slots=2, max_len=16, rt=rt, cuda_graph=True))
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def models():
    """``{name: (JAX fp32 params, port fp32 params, JAX bf16 params, port
    bf16 params as fp32 numpy)}`` from the JAX initializer."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    out = {}
    for name in MODELS:
        jcfg, tcfg = _jax_cfg(name), port_cfg(name)
        jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
        jb = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        out[name] = (jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), tcfg)), jb,
                     _numpy(params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jb), tcfg)))
    return out


@pytest.fixture(scope="module")
def unsharded(models):
    """The port's unsharded fp32 loss and gradients per model."""
    memo = {}

    def get(name):
        if name not in memo:
            cfg = port_cfg(name)
            params = _to_torch(models[name][1])
            batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
            with Runtime(backend="reference", device="cpu", **GEOM).use():
                loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, params, batch)
            memo[name] = float(loss), [g.numpy() for g in grads]
        return memo[name]

    return get


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _check_grads(cfg, grads, want):
    paths = _paths(TM.param_specs(cfg))
    assert len(grads) == len(want) == len(paths)
    for path, g, w in zip(paths, grads, want):
        if path == "params/layers/0/ln1":
            np.testing.assert_allclose(g, w, rtol=0, atol=LN1_STEP * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=path)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_fp32_loss_and_gradients_match_the_unsharded_port(pool, models, unsharded, name, shape):
    cfg = port_cfg(name)
    batch = _batch(cfg)
    uloss, ugrads = unsharded(name)
    rows = B // shape[0]
    v_local = cfg.vocab_size // shape[1]
    for loss, grads, cut, data_rank, head in pool.run(task_loss_grads, name, shape, models[name][1], batch,
                                                      deadline=DEADLINE):
        assert loss == pytest.approx(uloss, rel=1e-5, abs=1e-5)
        _check_grads(cfg, grads, ugrads)
        # every leaf of the batch cut over data: embeddings, M-RoPE streams,
        # the audio labels [B, S, K]
        assert sorted(cut) == sorted(batch)
        for k, v in batch.items():
            np.testing.assert_array_equal(cut[k], v[data_rank * rows:(data_rank + 1) * rows])
        # the head vocab-parallel on its last axis (FSDP over data on d)
        assert head == ((cfg.num_codebooks,) if cfg.frontend == "audio" else ()) + (cfg.d_model // shape[0], v_local)


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_train_step_at_two_microbatches_matches_the_unsharded_port(pool, models, name):
    cfg = port_cfg(name)
    batch = _batch(cfg, seed=6)
    params = _to_torch(models[name][1])
    with Runtime(backend="reference", device="cpu", **GEOM).use():
        fn = tstep.make_train_step(cfg, tadamw.OptConfig(**OPT), microbatches=2)
        p2, _, m = fn(params, tstep.init_train_state(cfg, params), {k: torch.from_numpy(v) for k, v in batch.items()})
    want = [x.detach().numpy() for x in tadamw.tree_leaves(p2)]
    for loss, got in pool.run(task_step, name, (2, 2), models[name][1], batch, 2, deadline=DEADLINE):
        assert loss == pytest.approx(float(m["loss"]), rel=1e-5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_bf16_loss_matches_jax_sharded(pool, models, name, shape):
    import jax
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.models import model as JM
    from repro.parallel.sharding import ShardingPolicy

    cfg, jcfg = port_cfg(name), _jax_cfg(name)
    batch = _batch(cfg)
    with jrt.use(jrt.Runtime(backend="reference", sharding=ShardingPolicy(mesh=_jax_mesh(shape)), **GEOM)):
        jloss = float(jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b))(models[name][2],
                                                                   {k: jnp.asarray(v) for k, v in batch.items()}))
    for loss in pool.run(task_bf16_loss, name, shape, models[name][3], batch, deadline=DEADLINE):
        np.testing.assert_allclose(loss, jloss, **BF16)


def test_what_a_mesh_of_several_ranks_still_refuses(pool, models):
    from repro_torch.models.common import init_params

    ssm = _numpy(init_params(TM.param_specs(reduce_config(get_config("mamba2-780m"))), seed=0,
                             dtype=torch.float32, device="cpu"))
    for out in pool.run(task_refusals, models["qwen2-vl-relu"][1], ssm, deadline=DEADLINE):
        assert out["engine frontend"].startswith("NotImplementedError") and "serves token prompts" in out["engine frontend"]
        assert out["launcher frontend"].startswith("NotImplementedError") and "inputs_embeds" in out["launcher frontend"]
        assert out["dst"] is None  # runs on a mesh of several ranks now
        assert out["cuda graph"].startswith("ValueError") and "mesh of 4 ranks" in out["cuda graph"]
