"""repro_torch.models.ssm (and the SSM family of the dispatch) against
repro.models.ssm on the CPU.

The same seeded numpy inputs and the JAX initializer's weights (carried
across by ``tensor_from_numpy`` / ``params_from_jax``) go through both
packages; the JAX side runs under ``reference`` or ``dense``, never
``interpret``.

* The spec tree: the same leaves, shapes and initializers as ``ssm_specs``.
* ``_causal_conv`` and ``_conv_step``.
* ``ssd_chunked`` over two chunks (S = 16, chunk 8) and over one chunk of
  the whole sequence (S = 7 is no multiple of 8, so Q = S), with and
  without an initial state; and over a 64-token chunk whose masked decay
  exponents overflow fp32: JAX's gradient is NaN there, the port's equals
  a float64 token-by-token recurrence's.
* ``ssm_fwd`` with its cache, then three ``ssm_decode`` steps after it:
  the outputs, and the cache the port overwrites in place (JAX returns a
  new one).  The decode caches hold bf16 conv tails and an fp32 state;
  JAX's ``_conv_step`` promotes its tails to the activation dtype (fp32
  here), so between steps its cache is cast back to those dtypes, as the
  port's in-place write casts (and as JAX's engine needs: its scan carry
  keeps the cache's dtypes).
* Reduced mamba2-780m (2 layers, d_model 64, state 16, chunk 8), fp32 and
  bf16, on ``dense`` and ``reference``: ``forward`` over two chunks,
  ``prefill`` (its caches too) and three ``decode_step`` calls; the
  converted parameter tree; ``init_cache`` / ``grow_caches`` /
  ``cache_batch_axes`` against JAX's stacked layouts.

Tolerances: fp32 rtol = atol = 1e-5 (the plain products and the einsums
sum in another order than XLA's); bf16 ``test_torch_model.TOL`` (atol 0.1:
XLA's bf16 ``sigmoid`` rounds otherwise than torch's in about a quarter of
the elements, one bf16 step each, and every projection rounds to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from test_torch_model import TOL as MODEL_TOL

GEOM = dict(bm=8, bk=16, bn=16)
ARCH = "mamba2-780m"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": MODEL_TOL["bfloat16"]}
#: the reduced config's SSM widths (``reduce_config``)
SSM_KW = dict(d_model=64, d_state=16, head_dim=16, chunk=8)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ssm(dtype_name="float32", seed=0):
    """(JAX SSMConfig, port SSMConfig, JAX params, port params)."""
    jcfg, tcfg = JS.SSMConfig(**SSM_KW), TS.SSMConfig(**SSM_KW)
    jp = jinit_params(JS.ssm_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    # the JAX initializer leaves dt_bias at 0 and a_log at 1: draw them, so
    # the decay differs per head
    rng = np.random.default_rng(seed + 100)
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(0, 0.5, jcfg.num_heads), jp["dt_bias"].dtype),
              a_log=jnp.asarray(rng.normal(0, 0.5, jcfg.num_heads), jp["a_log"].dtype))
    tp = jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x)), jp)
    return jcfg, tcfg, jp, tp


def _x(shape, dtype_name="float32", seed=1, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype_name)), torch.from_numpy(x).to(getattr(torch, dtype_name))


def _close(j, t, dtype_name="float32"):
    assert tuple(t.shape) == tuple(np.shape(j))
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------


def test_spec_tree_matches_jax():
    js, ts = JS.ssm_specs(JS.SSMConfig(**SSM_KW)), TS.ssm_specs(TS.SSMConfig(**SSM_KW))
    assert list(js) == list(ts)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape) and ts[k].init == js[k].init, k
    assert TS.SSMConfig(**SSM_KW).num_heads == JS.SSMConfig(**SSM_KW).num_heads == 8


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step_match_jax(dtype_name):
    jx, tx = _x((2, 9, 24), dtype_name, seed=2)
    jw, tw = _x((4, 24), dtype_name, seed=3, scale=0.5)
    jb, tb = _x((24,), dtype_name, seed=4, scale=0.1)
    _close(JS._causal_conv(jx, jw, jb), TS._causal_conv(tx, tw, tb), dtype_name)
    # the conv state in the cache's dtype (bf16) against a new token in the
    # activation dtype: the window promotes, as jnp.concatenate does
    jst, tst = _x((2, 3, 24), "bfloat16", seed=5)
    jn, tn = _x((2, 24), dtype_name, seed=6)
    jy, jwin = JS._conv_step(jn, jst, jw, jb)
    ty, twin = TS._conv_step(tn, tst, tw, tb)
    assert ty.dtype == getattr(torch, dtype_name) and twin.dtype == getattr(torch, dtype_name)
    _close(jy, ty, dtype_name)
    _close(jwin, twin[:, 1:], dtype_name)  # JAX returns the new state, the port the window


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "init-state"])
@pytest.mark.parametrize("s", [16, 7], ids=["two-chunks", "q=s"])
def test_ssd_chunked_matches_jax(s, init):
    b, h, p, n = 2, 3, 4, 5
    jx, tx = _x((b, s, h, p), seed=7)
    dt = np.abs(np.random.default_rng(8).standard_normal((b, s, h))).astype(np.float32) * 0.5
    jdt, tdt = jnp.asarray(dt), torch.from_numpy(dt)
    ja, ta = _x((h,), seed=9, scale=0.5)
    jbi, tbi = _x((b, s, n), seed=10)
    jci, tci = _x((b, s, n), seed=11)
    js0, ts0 = _x((b, h, p, n), seed=12) if init else (None, None)
    jy, jstate = JS.ssd_chunked(jx, jdt, ja, jbi, jci, chunk=8, init_state=js0)
    ty, tstate = TS.ssd_chunked(tx, tdt, ta, tbi, tci, chunk=8, init_state=ts0)
    assert ty.dtype == torch.float32 and tstate.dtype == torch.float32
    _close(jy, ty)
    _close(jstate, tstate)
    if s == 16:
        # the chunked result equals one chunk over the whole sequence
        one, state = TS.ssd_chunked(tx, tdt, ta, tbi, tci, chunk=16, init_state=ts0)
        _close(np.asarray(ty), one)
        _close(np.asarray(tstate), state)


def _ssd_scan64(x, dt, a_log, b_in, c_in):
    """The SSD recurrence one token at a time in float64 (the plain
    reference: ``state = exp(dt * a) * state + B (x dt)``, ``y = C state``),
    whose decay factors are at most 1, so nothing overflows."""
    a = -torch.exp(a_log.double())
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], b_in.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t].double()
        state = torch.exp(dtt * a)[..., None, None] * state + torch.einsum(
            "bhp,bn->bhpn", x[:, t].double() * dtt[..., None], b_in[:, t].double())
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_in[:, t].double()))
    return torch.stack(ys, dim=1)


def test_ssd_chunked_gradient_is_finite_where_the_decay_overflows():
    """A chunk of 64 tokens decaying ~3 nats a token puts ``exp`` of the
    masked (upper-triangle) exponents far past fp32's range, as the
    registered configs' 128-token chunks do at initialisation.  The values
    equal JAX's; JAX's gradient, the ``0 * inf`` of a where after exp, is
    NaN; the port, which masks the exponent before exp, gives the float64
    recurrence's gradient and, for ``x``, JAX's (rtol = atol = 1e-4: sums of
    64 terms in another order)."""
    b, s, h, p, n = 2, 64, 3, 4, 5
    rng = np.random.default_rng(13)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (1.0 + rng.random((b, s, h))).astype(np.float32)
    a_log = np.full((h,), 0.5, np.float32)  # a = -e**0.5: 1.6 to 3.3 nats a token
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((b, s, h, p)).astype(np.float32)  # a fixed cotangent

    def jloss(x, dt):
        return jnp.sum(JS.ssd_chunked(x, dt, a_log, b_in, c_in, chunk=64)[0] * w)

    jy, _ = JS.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), a_log, b_in, c_in, chunk=64)
    jgx, jgdt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(dt))
    assert np.isnan(np.asarray(jgdt)).any()  # through the decay; x's gradient stays finite
    tx, tdt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(dt).requires_grad_()
    tb, tc, ta, tw = (torch.from_numpy(v) for v in (b_in, c_in, a_log, w))
    ty, _ = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=64)
    _close(jy, ty.detach())
    gx, gdt = torch.autograd.grad((ty * tw).sum(), (tx, tdt))
    x64, dt64 = torch.from_numpy(x).double().requires_grad_(), torch.from_numpy(dt).double().requires_grad_()
    ref = _ssd_scan64(x64, dt64, ta, tb, tc)
    np.testing.assert_allclose(ty.detach().double().numpy(), ref.detach().numpy(), rtol=1e-4, atol=1e-4)
    rx, rdt = torch.autograd.grad((ref * tw.double()).sum(), (x64, dt64))
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
    np.testing.assert_allclose(gx.double().numpy(), rx.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)  # 64-term sums
    np.testing.assert_allclose(gdt.double().numpy(), rdt.numpy(), rtol=1e-4, atol=1e-4)


def _decode_cache(cfg, jcache):
    """JAX's prefill cache in the decode caches' dtypes, on both sides."""
    jc = jax.tree.map(lambda x, z: x.astype(z.dtype), jcache, JS.init_ssm_cache(cfg, jcache.state.shape[0]))
    return jc, TS.SSMCache(*(tensor_from_numpy(np.asarray(x)) for x in jc))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ssm_fwd_cache_and_decode_after_it_match_jax(dtype_name):
    jcfg, tcfg, jp, tp = _ssm(dtype_name, seed=3)
    jx, tx = _x((2, 11, 64), dtype_name, seed=13)
    jy, jcache = JS.ssm_fwd(jp, jcfg, jx, return_cache=True)
    ty, tcache = TS.ssm_fwd(tp, tcfg, tx, return_cache=True)
    assert ty.dtype == getattr(torch, dtype_name) and tcache.conv_x.dtype == ty.dtype
    assert tcache.state.dtype == torch.float32
    _close(jy, ty, dtype_name)
    for j, t in zip(jcache, tcache):
        _close(j, t, dtype_name)
    jc, tc = _decode_cache(jcfg, jcache)
    assert tc.conv_x.dtype == torch.bfloat16 and tuple(tc.state.shape) == (2, 8, 16, 16)
    bufs = tuple(tc)
    for step in range(3):
        jx1, tx1 = _x((2, 1, 64), dtype_name, seed=20 + step)
        jy, jc = JS.ssm_decode(jp, jcfg, jx1, jc)
        jc = jax.tree.map(lambda x, z: x.astype(z.dtype), jc, JS.init_ssm_cache(jcfg, 2))
        ty, tc = TS.ssm_decode(tp, tcfg, tx1, tc)
        assert all(a is b for a, b in zip(tc, bufs))  # written in place
        assert ty.dtype == getattr(torch, dtype_name) and tc.conv_x.dtype == torch.bfloat16
        _close(jy, ty, dtype_name)
        for j, t in zip(jc, tc):
            _close(j, t, dtype_name)


def test_decode_continues_the_forward_exactly():
    """With fp32 conv tails the recurrent step after a prefix equals the
    forward's next position (the SSD's two forms of one recurrence)."""
    _, tcfg, _, tp = _ssm("float32", seed=4)
    _, tx = _x((2, 10, 64), seed=14)
    full = TS.ssm_fwd(tp, tcfg, tx)
    _, cache = TS.ssm_fwd(tp, tcfg, tx[:, :-1], return_cache=True)
    state = TS.init_ssm_cache(tcfg, 2, dtype=torch.float32)
    for buf, part in zip(state, cache):
        buf.copy_(part)
    y, _ = TS.ssm_decode(tp, tcfg, tx[:, -1:], state)
    np.testing.assert_allclose(y.numpy(), full[:, -1:].numpy(), **TOL["float32"])


# ---------------------------------------------------------------------------
# the SSM family: reduced mamba2-780m
# ---------------------------------------------------------------------------


def _model(dtype_name="float32", seed=0):
    jcfg = jconfigs.reduce_config(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduce_config(tconfigs.get_config(ARCH))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.family == "ssm"
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def test_params_from_jax_unstacks_the_layers():
    jcfg, tcfg, jp, tp = _model("bfloat16")
    assert sorted(tp) == ["embed", "final_norm", "layers", "lm_head"]
    assert len(tp["layers"]) == tcfg.num_layers == 2
    specs = TM.param_specs(tcfg)
    for i, layer in enumerate(tp["layers"]):
        assert sorted(layer) == ["ln", "ssm"] and sorted(layer["ssm"]) == sorted(specs["layers"][i]["ssm"])
        for k, t in layer["ssm"].items():
            j = np.asarray(jp["layers"]["ssm"][k][i])
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(specs["layers"][i]["ssm"][k].shape)
            np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(jax.tree.map(np.asarray, jp), dataclasses.replace(tcfg, num_layers=3))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_mamba2_forward_prefill_and_decode_match_jax(backend, dtype_name):
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
    assert tl.shape == (b, s, jcfg.vocab_size) and tpl.shape == (b, 1, jcfg.vocab_size)
    _close(jl, tl, dtype_name)
    _close(jpl, tpl, dtype_name)
    assert len(tc) == tcfg.num_layers and all(isinstance(c, TS.SSMCache) for c in tc)
    for layer, cache in enumerate(tc):
        for field in TS.SSMCache._fields:
            _close(getattr(jc, field)[layer], getattr(cache, field), dtype_name)
    layout = JM.init_cache(jcfg, b, max_len)
    with jrt.use(jr):
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    with tr.use():
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    assert tc[0].conv_x.dtype == torch.bfloat16 and tc[0].state.dtype == torch.float32
    pos = np.array([s0, s0], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
            jc = jax.tree.map(lambda x, z: x.astype(z.dtype), jc, layout)
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos).long())
        _close(jl, tl, dtype_name)
        pos = pos + 1
    for layer, cache in enumerate(tc):
        for field in TS.SSMCache._fields:
            _close(getattr(jc, field)[layer].astype(jnp.float32), getattr(cache, field), dtype_name)


def test_cache_layouts_match_jax():
    """The port's per-layer caches are JAX's stacked ones sliced per layer:
    the same shapes and dtypes, each leaf's batch axis one less (no layer
    axis); ``grow_caches`` places a prefill cache at the origin, cast."""
    jcfg, tcfg, jp, tp = _model()
    jcache = JM.init_cache(jcfg, 3, 8)
    tcache = TM.init_cache(tcfg, 3, 8)
    assert len(tcache) == tcfg.num_layers
    for field in TS.SSMCache._fields:
        j = getattr(jcache, field)
        for layer in tcache:
            t = getattr(layer, field)
            assert tuple(t.shape) == tuple(j.shape[1:]) and str(t.dtype)[6:] == str(j.dtype)
            assert not t.any()
    jaxes, taxes = jrt.cache_batch_axes(jcfg), trt.cache_batch_axes(tcfg)
    assert [tuple(a) for a in taxes] == [tuple(x - 1 for x in jaxes)] * tcfg.num_layers
    toks = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    with trt.Runtime(backend="dense", device="cpu").use():
        _, part = TM.prefill(tp, tcfg, {"tokens": toks})
        grown = trt.Runtime(backend="dense", device="cpu").grow_caches(tcfg, part, 2, 8)
    for p, g in zip(part, grown):
        assert g.conv_x.dtype == torch.bfloat16 and torch.equal(g.conv_x, p.conv_x.to(torch.bfloat16))
        assert torch.equal(g.state, p.state)
