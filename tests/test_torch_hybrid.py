"""repro_torch.models.hybrid (and the hybrid family of the dispatch)
against repro.models.hybrid on the CPU.

The same seeded numpy inputs and the JAX initializer's weights (carried
across by ``params_from_jax``) go through both packages; the JAX side runs
under ``reference`` or ``dense``, never ``interpret``.  The model is reduced
zamba2-2.7b: 4 Mamba2 layers in 2 groups of 2, each group after one call of
the shared block (GQA of 4 query over 2 KV heads of 16, a gated tanh-GELU
MLP), d_model 64.

* The tanh GELU against ``jax.nn.gelu(approximate=True)``.
* ``_shared_block``, ``hybrid_forward`` and ``hybrid_prefill`` (its
  per-group KV caches and per-layer SSM caches), then three
  ``hybrid_decode`` steps with ``pos`` a scalar and a per-row vector, each
  from the same (the port's) caches: the outputs and the caches the port
  overwrites in place, a bf16 leaf within one bf16 step of JAX's.
* ``forward``/``prefill``/``decode_step`` of the reduced model, fp32 and
  bf16, on ``dense`` and ``reference`` (JAX's promoted fp32 conv tails
  cast back to the cache's bf16 between steps, as in ``test_torch_ssm``);
  the converted tree (``groups`` as a list of lists, ``shared`` as it is);
  the cache layouts against JAX's stacked ones.
* The initializer: every ``normal`` leaf's std is what the JAX initializer
  draws for it, the fan-in of the *stacked* shape (``[n_groups,
  attn_every, ...]`` for a hybrid group weight, ``[L, ...]`` for an SSM
  layer), on the registered configs' specs and in the drawn tensors.
* One ``make_train_step`` step of reduced mamba2-780m and reduced
  zamba2-2.7b against JAX's: loss and updated parameters.

Tolerances: fp32 rtol = atol = 1e-5; bf16 ``test_torch_model.TOL``; the
train step as ``test_torch_train``'s MoE step holds it (``MOE_TOL`` where
the gradient is well conditioned, within ``2 * lr`` elsewhere).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as JA
from repro.models import hybrid as JH
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.common import Spec as JSpec
from repro.models.common import _fan_in as jfan_in
from repro.models.common import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.models import attention as TA
from repro_torch.models import hybrid as TH
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.common import ACTIVATIONS, _fan_in, gelu, init_params
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from test_torch_model import TOL as MODEL_TOL
from test_torch_train import MOE_TOL, OPT, WELL_CONDITIONED, _jax_leaves_as_port

GEOM = dict(bm=8, bk=16, bn=16)
ARCH = "zamba2-2.7b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": MODEL_TOL["bfloat16"]}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(dtype_name="float32", seed=0, arch=ARCH):
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _x(shape, dtype_name="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype_name)), torch.from_numpy(x).to(getattr(torch, dtype_name))


def _close(j, t, dtype_name="float32"):
    assert tuple(t.shape) == tuple(np.shape(j))
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


def _close_cache(j, t):
    """A decode cache leaf: a bf16 one within one bf16 step of JAX's (the
    values before the rounding differ in the last fp32 bits, which can flip
    it), an fp32 one (the SSM state) within ``TOL["float32"]``."""
    tol = dict(rtol=2**-7, atol=1e-6) if t.dtype == torch.bfloat16 else TOL["float32"]
    assert tuple(t.shape) == tuple(np.shape(j))
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def _cast_like(tree, like):
    return jax.tree.map(lambda x, z: x.astype(z.dtype), tree, like)


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------


def test_tanh_gelu_equals_jax():
    jx, tx = _x((4096,), seed=2)
    jx, tx = jx * 4, tx * 4
    np.testing.assert_allclose(gelu(tx).numpy(), np.asarray(jax.nn.gelu(jx, approximate=True)),
                               rtol=1e-6, atol=1e-6)
    assert ACTIVATIONS["gelu"] is gelu
    # the erf form (torch's default) is another function
    erf = torch.nn.functional.gelu(tx)
    assert float((erf - gelu(tx)).abs().max()) > 1e-4


def test_configs_and_param_tree_match_jax():
    jcfg, tcfg, jp, tp = _model("bfloat16")
    assert TH.shared_attn_config(tconfigs.get_config(ARCH)).head_dim == 80
    for f in ("d_model", "d_state", "expand", "head_dim", "conv_width", "chunk"):
        assert getattr(TH.ssm_config(tcfg), f) == getattr(JH.ssm_config(jcfg), f)
    tattn, jattn = dataclasses.asdict(TH.shared_attn_config(tcfg)), dataclasses.asdict(JH.shared_attn_config(jcfg))
    assert tattn == {k: jattn[k] for k in tattn}  # JAX's others (window, M-RoPE, ...) stay off
    assert not any(jattn[k] for k in set(jattn) - set(tattn))
    assert sorted(tp) == ["embed", "final_norm", "groups", "lm_head", "shared"]
    assert [len(g) for g in tp["groups"]] == [tcfg.attn_every] * (tcfg.num_layers // tcfg.attn_every) == [2, 2]
    for g, group in enumerate(tp["groups"]):
        for i, layer in enumerate(group):
            for k, t in layer["ssm"].items():
                j = np.asarray(jp["groups"]["ssm"][k][g, i]).astype(np.float32)
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.float().numpy(), j)
    assert tp["shared"]["mlp"]["w_gate"].shape == (64, tcfg.shared_d_ff)
    np.testing.assert_array_equal(tp["shared"]["w_in"].float().numpy(),
                                  np.asarray(jp["shared"]["w_in"]).astype(np.float32))
    with pytest.raises(ValueError, match="groups"):
        params_from_jax(jax.tree.map(np.asarray, jp), dataclasses.replace(tcfg, num_layers=6))


def test_shared_block_matches_jax():
    jcfg, tcfg, jp, tp = _model(seed=1)
    jh, th = _x((2, 9, 64), seed=3)
    jh0, th0 = _x((2, 9, 64), seed=4)
    jpos, tpos = jnp.arange(9), torch.arange(9)
    rope = TA.rope_tables(TH.shared_attn_config(tcfg), tpos)
    want = JH._shared_block(jp["shared"], jcfg, jh, jh0, jpos)
    _close(want, TH._shared_block(tp["shared"], tcfg, th, th0, tpos, rope))
    jgot, jcache = JH._shared_block_cached(jp["shared"], jcfg, jh, jh0, jpos, True)
    tgot, tcache = TH._shared_block(tp["shared"], tcfg, th, th0, tpos, rope, return_cache=True)
    _close(jgot, tgot)
    _close(jcache.k, tcache.k)
    _close(jcache.v, tcache.v)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-pos", "per-row-pos"])
def test_hybrid_forward_prefill_and_decode_match_jax(per_row):
    jcfg, tcfg, jp, tp = _model(seed=2)
    b, s0, max_len = 3, 6, 12
    jh, th = _x((b, s0, 64), seed=5)
    jpos, tpos = jnp.arange(s0), torch.arange(s0)
    _close(JH.hybrid_forward(jp, jcfg, jh, jpos), TH.hybrid_forward(tp, tcfg, th, tpos))
    jout, jc = JH.hybrid_prefill(jp, jcfg, jh, jpos)
    tout, tc = TH.hybrid_prefill(tp, tcfg, th, tpos)
    _close(jout, tout)
    assert isinstance(tc, TH.HybridCache) and len(tc.kv) == len(tc.ssm) == 2
    for g in range(2):
        _close(jc.kv.k[g], tc.kv[g].k)
        for i in range(tcfg.attn_every):
            for field in TS.SSMCache._fields:
                _close(getattr(jc.ssm, field)[g, i], getattr(tc.ssm[g][i], field))
    tc = trt.Runtime(backend="dense", device="cpu").grow_caches(tcfg, tc, b, max_len)
    assert tc.kv[0].k.dtype == tc.ssm[1][0].conv_b.dtype == torch.bfloat16
    bufs = [tc.kv[0].k, tc.ssm[1][1].state]
    pos = np.array([s0, s0 + 2, s0 + 1], np.int32) if per_row else np.int32(s0)
    for step in range(3):
        # each step from the same caches: a bf16 cache leaf may sit one
        # rounding apart (see _close_cache), and a step held to 1e-5 must not
        # inherit that
        jc = _as_jax_cache(tc)
        jx, tx = _x((b, 1, 64), seed=10 + step)
        jy, jc = JH.hybrid_decode(jp, jcfg, jx, jc, jnp.asarray(pos))
        ty, tc = TH.hybrid_decode(tp, tcfg, tx, tc, torch.from_numpy(np.asarray(pos)).long())
        assert tc.kv[0].k is bufs[0] and tc.ssm[1][1].state is bufs[1]  # in place
        _close(jy, ty)
        for g in range(2):
            _close_cache(jc.kv.k[g].astype(jnp.float32), tc.kv[g].k)
            _close_cache(jc.kv.v[g].astype(jnp.float32), tc.kv[g].v)
            for i in range(tcfg.attn_every):
                for field in TS.SSMCache._fields:
                    _close_cache(getattr(jc.ssm, field)[g, i].astype(jnp.float32), getattr(tc.ssm[g][i], field))
        pos = pos + 1


def _as_jax_cache(tc):
    """The port's ``HybridCache`` as JAX's, stacked per group (and layer)."""
    arr = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                          else jnp.float32)
    kv = JA.KVCache(k=jnp.stack([arr(c.k) for c in tc.kv]), v=jnp.stack([arr(c.v) for c in tc.kv]))
    ssm = JS.SSMCache(*(jnp.stack([jnp.stack([arr(getattr(c, f)) for c in g]) for g in tc.ssm])
                        for f in TS.SSMCache._fields))
    return JH.HybridCache(ssm=ssm, kv=kv)


# ---------------------------------------------------------------------------
# the hybrid family: reduced zamba2-2.7b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_zamba2_forward_prefill_and_decode_match_jax(backend, dtype_name):
    jcfg, tcfg, jp, tp = _model(dtype_name)
    rng = np.random.default_rng(1)
    b, s, s0, max_len = 2, 16, 11, 16
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        jpl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s0])})
    with tr.use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        tpl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :s0])})
    _close(jl, tl, dtype_name)
    _close(jpl, tpl, dtype_name)
    layout = JM.init_cache(jcfg, b, max_len)
    with jrt.use(jr):
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    with tr.use():
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    pos = np.array([s0, s0 + 1], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep_fn(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
            jc = _cast_like(jc, layout)
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos).long())
        _close(jl, tl, dtype_name)
        pos = pos + 1


def test_cache_layouts_match_jax():
    jcfg, tcfg, _, _ = _model()
    jcache, tcache = JM.init_cache(jcfg, 3, 8), TM.init_cache(tcfg, 3, 8)
    assert isinstance(tcache, TH.HybridCache)
    for g in range(2):
        for f in ("k", "v"):
            j, t = getattr(jcache.kv, f), getattr(tcache.kv[g], f)
            assert tuple(t.shape) == tuple(j.shape[1:]) and t.dtype == torch.bfloat16
        for i in range(tcfg.attn_every):
            for f in TS.SSMCache._fields:
                j, t = getattr(jcache.ssm, f), getattr(tcache.ssm[g][i], f)
                assert tuple(t.shape) == tuple(j.shape[2:]) and str(t.dtype)[6:] == str(j.dtype)
    jaxes, taxes = jrt.cache_batch_axes(jcfg), trt.cache_batch_axes(tcfg)
    # both KVCaches carry the int8 cache's scales (None here)
    assert [tuple(a) for a in taxes.kv] == [tuple(None if x is None else x - 1 for x in jaxes.kv)] * 2
    assert [[tuple(c) for c in g] for g in taxes.ssm] == [[tuple(x - 2 for x in jaxes.ssm)] * 2] * 2


# ---------------------------------------------------------------------------
# the initializer's scales
# ---------------------------------------------------------------------------


def _std_pairs(tspecs, jspecs, path=""):
    """``(path, port std, JAX std)`` of every ``normal`` leaf: the JAX tree
    stacked, the port's per layer (``layers`` one list, ``groups`` two)."""
    if isinstance(jspecs, JSpec):
        std = lambda s, fan: s.scale if s.scale is not None else 1 / math.sqrt(fan(s.shape))
        if jspecs.init != "normal":
            assert tspecs.init == jspecs.init, path
            return []
        return [(path, std(tspecs, _fan_in), std(jspecs, jfan_in))]
    if isinstance(tspecs, list):
        return [p for i, t in enumerate(tspecs) for p in _std_pairs(t, jspecs, f"{path}/{i}")]
    return [p for k in jspecs for p in _std_pairs(tspecs[k], jspecs[k], f"{path}/{k}")]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_init_scales_follow_jax_stacked_fan_in(arch):
    """At the registered and the reduced widths the port's spec of every
    leaf gives the std JAX draws for it (a zamba2 group weight ``[9, 6,
    2560, 5120]``: ``1/sqrt(6 * 2560)``, not ``1/sqrt(2560)``); on the
    reduced config the drawn tensors' stds agree with it within sampling
    error."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    full_pairs = _std_pairs(TM.param_specs(tcfg), JM.param_specs(jcfg))
    tcfg, jcfg = tconfigs.reduce_config(tcfg), jconfigs.reduce_config(jcfg)
    pairs = _std_pairs(TM.param_specs(tcfg), JM.param_specs(jcfg))
    for ps in (full_pairs, pairs):
        assert ps and all(t == pytest.approx(j, rel=1e-12) for _, t, j in ps)
    full = {p: t for p, t, _ in full_pairs}
    if arch == "zamba2-2.7b":
        assert full["/groups/8/5/ssm/in_z"] == pytest.approx(1 / math.sqrt(6 * 2560))
        assert full["/groups/0/0/ssm/conv_x_w"] == pytest.approx(1 / math.sqrt(6 * 4))
        assert full["/shared/w_in"] == pytest.approx(1 / math.sqrt(2 * 2560))
    else:
        assert full["/layers/47/ssm/in_z"] == pytest.approx(1 / math.sqrt(1536))
    params = init_params(TM.param_specs(tcfg), seed=0, dtype=torch.float32, device="cpu")
    for path, want, _ in pairs:
        t = params
        for k in path.strip("/").split("/"):
            t = t[int(k)] if isinstance(t, list) else t[k]
        assert abs(float(t.std()) / want - 1) < 5 / math.sqrt(2 * t.numel()), path


# ---------------------------------------------------------------------------
# one training step of each family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_train_step_equals_jax(arch):
    """One plain ``make_train_step`` step (no taps: both packages refuse
    them for these families) on ``reference``, fp32, from the same weights
    and batch: the loss, and the updated parameters as the MoE step holds
    them.  The 16-token sequences are two ``ssm_chunk``\\ s, so the gradient
    runs through ``ssd_chunked``'s chunked path."""
    jcfg, tcfg, jp, tp = _model(arch=arch)
    assert 16 == 2 * tcfg.ssm_chunk
    jbatch = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=5).batch_at(0)
    tbatch = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=5).batch_at(0, device="cpu")
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        jloss, jgrads = jax.value_and_grad(jstep.make_loss_fn(jcfg))(jp, jbatch)
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT)))
        jp2, _, jm = jfn(jp, jadamw.init_opt_state(jp), jbatch)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(tcfg), tcfg, tp, tbatch)
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT))
        tp2, _, tm = fn(tp, tstep.init_train_state(tcfg, tp), tbatch)
        with pytest.raises(ValueError, match="sparsity_taps"):
            tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), sparsity_taps=True)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    for g, jg in zip(grads, _jax_leaves_as_port(jgrads, tcfg)):
        np.testing.assert_allclose(g.float().numpy(), jg.numpy(), **MOE_TOL)
    conditioned = 0
    for t, j, g, jg in zip(tadamw.tree_leaves(tp2), _jax_leaves_as_port(jp2, tcfg), grads,
                           _jax_leaves_as_port(jgrads, tcfg)):
        t, j, g, jg = t.detach().numpy(), j.numpy(), g.float().numpy(), jg.numpy()
        well = (np.abs(jg) >= WELL_CONDITIONED) | ((g == 0) & (jg == 0))
        np.testing.assert_allclose(t[well], j[well], **MOE_TOL)
        np.testing.assert_array_less(np.abs(t - j), 2 * OPT["lr"])
        conditioned += int(well.sum())
    assert conditioned > 0.98 * sum(p.numel() for p in tadamw.tree_leaves(tp2))
