"""Gemma-2 in repro_torch against repro on the CPU: sliding-window attention
alternating local and global layers, zero-centred sandwich norms, logit
softcaps and the embedding scale.

The model is reduced gemma2-2b (``reduce_config``: 2 layers, d_model 64, 4
query heads over 2 KV heads of 16, ``sliding_window`` 8), with fp32
parameters from the JAX initializer carried across by ``params_from_jax``.
Sequences of 24 tokens run past the window, so the even (local) layers mask
keys that the odd (global) layers see.  The JAX side runs under
``reference`` or ``dense`` and takes its flags as scanned data (``window =
2**30`` on a global layer); the port's layers take a Python bool each.

* ``forward`` and ``prefill`` (its KV caches too) at ``q_chunk`` 32 (one
  chunk) and 8 (three chunks), then three decode steps with a per-row
  position past the window, GELU (as registered) and ReLU (the fused
  emitted-mask FFN under ``reference``).
* Each layer's attention alone: ``is_global`` as JAX's scanned flags set it
  (odd layers global), equal to JAX's ``attention_fwd`` with that flag, and
  a local layer's output differs from the same layer taken global.
* ``params_from_jax`` carries the two post-norm leaves of every layer.

Tolerance: fp32 rtol = atol = 1e-5 (the plain products and the softmax sum
in another order than XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "gemma2-2b"
S = 24  # tokens: three times the reduced window


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(seed=0, **kw):
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(ARCH)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(ARCH)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.sliding_window == 8 < S and tcfg.local_global_alternate and tcfg.post_norms
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _close(j, t):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL)


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("activation,q_chunk", [("gelu", 32), ("gelu", 8), ("relu", 32), ("relu", 8)])
def test_forward_prefill_and_decode_match_jax(activation, q_chunk, backend):
    jcfg, tcfg, jp, tp = _model(activation=activation, q_chunk=q_chunk)
    rng = np.random.default_rng(1)
    b, max_len, steps = 3, 32, 3
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, S)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(prompt)})
        jpl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)})
    with tr.use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
        tpl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
    assert tl.shape == (b, S, jcfg.vocab_size) and tpl.shape == (b, 1, jcfg.vocab_size)
    assert float(tl.abs().max()) <= tcfg.final_softcap
    _close(jl, tl)
    _close(jpl, tpl)
    for layer, cache in enumerate(tc["layers"]):
        _close(jc["layers"].k[layer], cache.k)
        _close(jc["layers"].v[layer], cache.v)
    with jrt.use(jr):
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    with tr.use():
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    pos = np.array([S, S + 1, S + 3], np.int32)  # each row at its own position
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos).long())
        _close(jl, tl)
        pos = pos + 1
    for layer, cache in enumerate(tc["layers"]):
        _close(jc["layers"].k[layer].astype(jnp.float32), cache.k)


def test_odd_layers_are_global_layer_by_layer():
    """Each layer's attention, fed the same input: the flag the port gives
    layer ``i`` is JAX's scanned ``_global_flags`` entry (odd layers
    global), its output equals JAX's ``attention_fwd`` under that flag, and
    on a local layer it differs from the same layer taken global (the
    window cuts)."""
    jcfg, tcfg, jp, tp = _model(num_layers=4)
    flags = np.asarray(JT._global_flags(jcfg, tcfg.num_layers)).tolist()
    assert flags == [False, True, False, True]
    jacfg, tacfg = JT.attn_config(jcfg), TT.attn_config(tcfg)
    assert (tacfg.sliding_window, tacfg.kv_quant) == (jacfg.sliding_window, jacfg.kv_quant) == (8, False)
    x = np.random.default_rng(2).standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jfwd = jax.jit(lambda p, x, g: JA.attention_fwd(p, jacfg, x, jnp.arange(S), is_global=g))
    positions = torch.arange(S)
    rope = TA.rope_tables(tacfg, positions)
    for i, flag in enumerate(flags):
        kw = TT._layer_kw(tcfg, i)
        assert kw == {"is_global": flag}
        p = tp["layers"][i]["attn"]
        got = TA.attention_fwd(p, tacfg, torch.from_numpy(x), positions, rope, **kw)
        _close(jfwd(jax.tree.map(lambda t: t[i], jp["layers"]["attn"]), jnp.asarray(x), jnp.bool_(flag)), got)
        other = TA.attention_fwd(p, tacfg, torch.from_numpy(x), positions, rope, is_global=not flag)
        # rows past the window see other keys under the other flag
        assert not torch.allclose(got[:, tacfg.sliding_window:], other[:, tacfg.sliding_window:], atol=1e-3)
        torch.testing.assert_close(got[:, :tacfg.sliding_window], other[:, :tacfg.sliding_window],
                                   rtol=0, atol=0)


def test_params_from_jax_carries_the_post_norms():
    jcfg, tcfg, jp, tp = _model(num_layers=3, seed=3)
    spec = TM.param_specs(tcfg)["layers"][0]
    assert set(spec) == set(JM.param_specs(jcfg)["layers"]) == {"ln1", "ln2", "attn", "mlp", "post_attn_norm",
                                                                "post_mlp_norm"}
    # the JAX initializer sets norm gains to ones; distinct values show the layer order
    jp = dict(jp, layers=dict(jp["layers"], **{
        name: jnp.asarray(np.random.default_rng(4 + k).standard_normal((3, tcfg.d_model)), jnp.float32)
        for k, name in enumerate(("post_attn_norm", "post_mlp_norm"))}))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    assert len(tp["layers"]) == 3
    for i, layer in enumerate(tp["layers"]):
        for name in ("post_attn_norm", "post_mlp_norm"):
            assert layer[name].dtype == torch.float32
            np.testing.assert_array_equal(layer[name].numpy(), np.asarray(jp["layers"][name][i]))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    with jrt.use(jrt.Runtime(backend="dense")):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with trt.Runtime(backend="dense", device="cpu").use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(jl, tl)
