"""repro_torch.models.mla (and the MLA attention of the backbone) against
repro.models.mla on the CPU.

The same seeded numpy inputs and the JAX initializer's weights (carried
across by ``tensor_from_numpy`` / ``params_from_jax``) go through both
packages; the JAX side runs under ``reference`` or ``dense``, never
``interpret``.

* The spec tree: the same leaves, shapes and initializers as ``mla_specs``.
* ``_queries``, ``_latent_kv`` and ``mla_fwd`` at ``S`` = 3 x ``q_chunk``
  (the chunked path), fp32 and bf16.
* ``mla_decode`` with a scalar and with a per-row ``pos``: the output and
  the cache rows it writes (the port in place, JAX by copy); and the
  absorbed decode against ``mla_fwd``'s last position on the same prefix.
* Reduced deepseek-v2-236b (3 layers: a dense first block and two MoE
  blocks of 8 experts top-2 with a shared expert; MLA with kv_lora 32), SiLU
  and ReLU, on ``dense`` and ``reference``: ``forward``, ``prefill`` (its
  latent caches too) and three per-row decode steps.
* ``ServeEngine``'s greedy tokens on reduced deepseek-v2-ReLU against JAX's
  engine, two slots backfilled.

Tolerances: fp32 rtol = atol = 1e-5 (the plain products and the softmax sum
in another order than XLA's; a decode step's bf16 cache rounds the latent);
bf16 ``test_torch_model.TOL`` (atol 0.1: every projection rounds to bf16,
so one flipped rounding propagates through the rest of the network).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.models import mla as JMLA
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.models.attention import decode_positions
from repro_torch.serve.engine import ServeEngine
from test_torch_model import TOL as MODEL_TOL

GEOM = dict(bm=8, bk=16, bn=16)
ARCH = "deepseek-v2-236b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": MODEL_TOL["bfloat16"]}
#: the reduced config's MLA widths (``reduce_config``) with a small query chunk
MLA_KW = dict(d_model=64, num_heads=4, kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16, q_chunk=4)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mla(dtype_name="float32", seed=0):
    """(JAX MLAConfig, port MLAConfig, JAX params, port params)."""
    jcfg = JMLA.MLAConfig(**MLA_KW)
    tcfg = TMLA.MLAConfig(**MLA_KW)
    jp = jinit_params(JMLA.mla_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x)), jp)
    return jcfg, tcfg, jp, tp


def _x(shape, dtype_name, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype_name)), torch.from_numpy(x).to(getattr(torch, dtype_name))


def _close(j, t, dtype_name):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------


def test_spec_tree_matches_jax():
    jcfg, tcfg = JMLA.MLAConfig(**MLA_KW), TMLA.MLAConfig(**MLA_KW)
    js, ts = JMLA.mla_specs(jcfg), TMLA.mla_specs(tcfg)
    assert sorted(js) == sorted(ts) == ["kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape) and ts[k].init == js[k].init, k
    assert tcfg.qk_head_dim == jcfg.qk_head_dim == 24
    _, _, jp, tp = _mla("bfloat16")
    for k in js:
        assert tp[k].dtype == torch.bfloat16 and tuple(tp[k].shape) == tuple(jp[k].shape)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_queries_latent_kv_and_chunked_fwd_match_jax(dtype_name):
    jcfg, tcfg, jp, tp = _mla(dtype_name, seed=2)
    s = 3 * tcfg.q_chunk  # three query chunks
    jx, tx = _x((2, s, 64), dtype_name, seed=3)
    jpos, tpos = jnp.arange(s), torch.arange(s)
    rope = TMLA.rope_tables(tcfg, tpos)
    for j, t in zip(JMLA._queries(jp, jcfg, jx, jpos), TMLA._queries(tp, tcfg, tx, rope)):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == getattr(torch, dtype_name)
        _close(j, t, dtype_name)
    for j, t in zip(JMLA._latent_kv(jp, jcfg, jx, jpos), TMLA._latent_kv(tp, tcfg, tx, rope)):
        assert tuple(t.shape) == tuple(j.shape)
        _close(j, t, dtype_name)
    want = JMLA.mla_fwd(jp, jcfg, jx, jpos)
    got, cache = TMLA.mla_fwd(tp, tcfg, tx, tpos, rope, return_cache=True)
    assert tuple(got.shape) == (2, s, 64) and got.dtype == getattr(torch, dtype_name)
    _close(want, got, dtype_name)
    # one chunk of all S queries gives the same output
    one = TMLA.mla_fwd(tp, dataclasses.replace(tcfg, q_chunk=1024), tx, tpos, rope)
    _close(np.asarray(got.float()), one, dtype_name)
    _close(JMLA._latent_kv(jp, jcfg, jx, jpos)[0], cache.c_kv, dtype_name)


def _prefilled(jp, jcfg, dtype_name, b, s0, max_len, seed=4):
    """Both packages' bf16 latent caches holding the same ``s0``-token
    prefix (the JAX one's rows, so the two start from equal caches)."""
    jx, _ = _x((b, s0, 64), dtype_name, seed=seed)
    c_kv, k_pe = JMLA._latent_kv(jp, jcfg, jx, jnp.arange(s0))
    jc = JMLA.init_mla_cache(jcfg, b, max_len)
    jc = JMLA.MLACache(c_kv=jc.c_kv.at[:, :s0].set(c_kv.astype(jnp.bfloat16)),
                       k_pe=jc.k_pe.at[:, :s0].set(k_pe.astype(jnp.bfloat16)))
    tc = TMLA.MLACache(*(tensor_from_numpy(np.asarray(x)) for x in jc))
    return jc, tc


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-pos", "per-row-pos"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_decode_and_the_cache_rows_it_writes_match_jax(dtype_name, per_row):
    jcfg, tcfg, jp, tp = _mla(dtype_name, seed=5)
    b, s0, max_len = 3, 6, 12
    jc, tc = _prefilled(jp, jcfg, dtype_name, b, s0, max_len)
    assert tc.c_kv.dtype == torch.bfloat16 and tuple(tc.c_kv.shape) == (b, max_len, tcfg.kv_lora_rank)
    pos = np.array([s0, s0 + 2, s0 + 1], np.int32) if per_row else np.int32(s0)
    starts = np.broadcast_to(pos, (b,)).copy()
    for step in range(3):
        jx, tx = _x((b, 1, 64), dtype_name, seed=10 + step)
        jy, jc = JMLA.mla_decode(jp, jcfg, jx, jc, jnp.asarray(pos))
        tpos = torch.from_numpy(np.asarray(pos)).long()
        rope = TMLA.rope_tables(tcfg, decode_positions(tpos, b, "cpu"))
        c_kv, k_pe = tc
        ty, tc = TMLA.mla_decode(tp, tcfg, tx, tc, tpos, rope)
        assert tc.c_kv is c_kv and tc.k_pe is k_pe  # written in place
        assert tuple(ty.shape) == (b, 1, 64) and ty.dtype == getattr(torch, dtype_name)
        _close(jy, ty, dtype_name)
        for j, t in zip(jc, tc):  # bf16 rows, the written ones included
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                                       **TOL[dtype_name])
        pos = pos + 1
    written = np.zeros((b, max_len), bool)
    written[:, :s0] = True
    for r, first in enumerate(starts):
        written[r, first:first + 3] = True
    assert not tc.c_kv[torch.from_numpy(~written)].any()  # rows past each frontier stay zero


def test_absorbed_decode_equals_naive_fwd_last_position():
    """The absorbed form over an fp32 latent cache of the prefix equals the
    up-projected form's output at the last position (fp32)."""
    _, tcfg, _, tp = _mla("float32", seed=6)
    s = 9
    _, tx = _x((2, s, 64), "float32", seed=7)
    pos = torch.arange(s)
    full = TMLA.mla_fwd(tp, tcfg, tx, pos, TMLA.rope_tables(tcfg, pos))
    c_kv, k_pe = TMLA._latent_kv(tp, tcfg, tx[:, :-1], TMLA.rope_tables(tcfg, pos[:-1]))
    cache = TMLA.init_mla_cache(tcfg, 2, 12, dtype=torch.float32)
    cache.c_kv[:, :s - 1] = c_kv
    cache.k_pe[:, :s - 1] = k_pe
    rope = TMLA.rope_tables(tcfg, decode_positions(torch.tensor(s - 1), 2, "cpu"))
    y, _ = TMLA.mla_decode(tp, tcfg, tx[:, -1:], cache, torch.tensor(s - 1), rope)
    np.testing.assert_allclose(y.numpy(), full[:, -1:].numpy(), **TOL["float32"])


# ---------------------------------------------------------------------------
# the MLA backbone: reduced deepseek-v2-236b
# ---------------------------------------------------------------------------


def _model(activation, dtype_name, seed=0):
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(ARCH)), activation=activation)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(ARCH)), activation=activation)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.use_mla
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("activation", ["silu", "relu"])
def test_deepseek_v2_forward_prefill_and_decode_match_jax(activation, backend, dtype_name):
    jcfg, tcfg, jp, tp = _model(activation, dtype_name)
    rng = np.random.default_rng(1)
    b, s0, max_len = 3, 6, 16
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, s0)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)})
        jpl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)})
    with tr.use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
        tpl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
    assert tl.shape == (b, s0, jcfg.vocab_size) and tpl.shape == (b, 1, jcfg.vocab_size)
    _close(jl, tl, dtype_name)
    _close(jpl, tpl, dtype_name)
    assert {k: len(v) for k, v in tc.items()} == {"dense_layers": 1, "layers": 2}
    for stack in tc:
        for layer, cache in enumerate(tc[stack]):
            assert isinstance(cache, TMLA.MLACache)
            for field in ("c_kv", "k_pe"):
                _close(getattr(jc[stack], field)[layer], getattr(cache, field), dtype_name)
    with jrt.use(jr):
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    with tr.use():
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    assert tc["layers"][0].c_kv.dtype == torch.bfloat16
    pos = np.array([s0, s0 + 1, s0 + 3], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos).long())
        _close(jl, tl, dtype_name)
        pos = pos + 1
    for stack in tc:
        for layer, cache in enumerate(tc[stack]):
            _close(jc[stack].c_kv[layer].astype(jnp.float32), cache.c_kv, dtype_name)


def test_deepseek_v2_engine_greedy_tokens_match_jax():
    """Five requests of mixed prompt lengths through two slots (so slots
    backfill and a chunk runs with an inactive slot): the greedy tokens equal
    JAX's ``ServeEngine``'s, fp32 on ``reference``, the MLA latent caches
    packed and written per slot by the runtime's cache-tree helpers."""
    jcfg, tcfg, jp, tp = _model("relu", "float32")
    rng = np.random.default_rng(7)
    plens, budgets = [5, 8, 5, 7, 8], [4, 6, 3, 5, 4]
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in plens]
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3,
                       rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    for p, n in zip(prompts, budgets):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout
    assert [len(tout[r]) for r in range(5)] == budgets
    assert all(isinstance(c, TMLA.MLACache) for c in teng.caches["layers"] + teng.caches["dense_layers"])
    assert all(r.ok for r in teng._requests.values())
