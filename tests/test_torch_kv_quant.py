"""The int8 KV cache (``kv_cache_quant``) of repro_torch against repro on
the CPU.

* The port's own fidelity, as ``tests/test_kv_quant.py`` holds JAX's:
  reduced deepseek-7b and gemma2-2b, prefill over 23 tokens, then one
  decode step on the int8 cache, within rtol = atol = 0.08 of the full
  forward's last logits; the cache's K/V are int8 and its scales fp32.
* The quantizer: ``_kv_quant_rows`` on the same rows (JAX's own unquantized
  prefill K/V, and rows that land exactly on half steps) gives JAX's int8
  values exactly (round half to even) and its scales within one ulp.
* The caches: each package's quantized prefill cache holds the same int8
  values, except where the two packages' K/V differ in a last bit across a
  rounding boundary (a value within 1e-4 of a half step, off by one there);
  ``Runtime.grow_caches`` keeps them int8 and fp32.
* Decode: from the same quantized caches (JAX's, carried across), three
  per-row decode steps give JAX's logits within fp32 rtol = atol = 1e-5, and
  write the same rows and scales in place.
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
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

ARCHS = ["deepseek-7b", "gemma2-2b"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(arch, seed=0):
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)), kv_cache_quant=True)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)), kv_cache_quant=True)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _tokens(vocab, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_kv_decode_close_to_fp(arch):
    _, tcfg, _, tp = _model(arch)
    toks = torch.from_numpy(_tokens(tcfg.vocab_size))
    s = toks.shape[1]
    rt = trt.Runtime(backend="dense", device="cpu")
    with rt.use():
        full = TM.forward(tp, tcfg, {"tokens": toks})
        _, caches = TM.prefill(tp, tcfg, {"tokens": toks[:, :-1]})
        caches = rt.grow_caches(tcfg, caches, 2, s)
        lg, _ = TM.decode_step(tp, tcfg, caches, {"tokens": toks[:, -1:]}, torch.tensor(s - 1))
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(), rtol=0.08, atol=0.08)


def test_int8_cache_is_int8():
    _, tcfg, _, _ = _model("deepseek-7b")
    cache = TM.init_cache(tcfg, 2, 16)
    layer = cache["layers"][0]
    assert layer.k.dtype == layer.v.dtype == torch.int8
    assert layer.k_scale.dtype == layer.v_scale.dtype == torch.float32
    assert tuple(layer.k_scale.shape) == (2, 16, tcfg.num_kv_heads, 1)
    plain = TM.init_cache(dataclasses.replace(tcfg, kv_cache_quant=False), 2, 16)["layers"][0]
    assert plain.k.dtype == torch.bfloat16 and plain.k_scale is None and plain.v_scale is None


def _assert_quantized_like_jax(x):
    jq, js = JA._kv_quant_rows(jnp.asarray(x))
    tq, ts = TA._kv_quant_rows(torch.from_numpy(np.array(x)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_array_equal(TA._kv_dequant(tq, ts, torch.float32).numpy(),
                                  np.asarray(JA._kv_dequant(jq, js, jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantizer_gives_jax_int8_rows_and_scales(arch):
    jcfg, _, jp, _ = _model(arch)
    toks = jnp.asarray(_tokens(jcfg.vocab_size))
    _, plain = JM.prefill(jp, dataclasses.replace(jcfg, kv_cache_quant=False), {"tokens": toks})
    _, quant = JM.prefill(jp, jcfg, {"tokens": toks})
    for leaf, scale in (("k", "k_scale"), ("v", "v_scale")):
        x = np.array(getattr(plain["layers"], leaf))
        _assert_quantized_like_jax(x)
        tq, ts = TA._kv_quant_rows(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(getattr(quant["layers"], leaf)))
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(getattr(quant["layers"], scale)), maxulp=1)
    # rows whose scaled values land on half steps: 127 / 2 = 63.5 round to even
    halves = np.array([[127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, -2.5],
                       [0.0] * 8], np.float32)
    _assert_quantized_like_jax(halves)
    tq, ts = TA._kv_quant_rows(torch.from_numpy(halves))
    assert tq[0].tolist() == [127, 64, -64, 0, 0, 2, 2, -2] and tq[1].tolist() == [0] * 8
    assert float(ts[1, 0]) == np.float32(1e-12) / np.float32(127.0)  # an all-zero row


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(jcfg.vocab_size)
    _, plain = JM.prefill(jp, dataclasses.replace(jcfg, kv_cache_quant=False), {"tokens": jnp.asarray(toks)})
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    rt = trt.Runtime(backend="dense", device="cpu")
    with rt.use():
        _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    moved = 0
    for leaf, scale in (("k", "k_scale"), ("v", "v_scale")):
        for layer, cache in enumerate(tc["layers"]):
            got, want = getattr(cache, leaf).numpy(), np.asarray(getattr(jc["layers"], leaf)[layer])
            assert got.dtype == np.int8
            js = np.asarray(getattr(jc["layers"], scale)[layer])
            np.testing.assert_allclose(getattr(cache, scale).numpy(), js, **TOL)
            scaled = np.asarray(getattr(plain["layers"], leaf)[layer]) / js
            tie = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) < 1e-4
            diff = got.astype(np.int32) - want.astype(np.int32)
            assert np.all((diff == 0) | (tie & (np.abs(diff) == 1)))
            moved += int((diff != 0).sum())
    assert moved <= 2  # near-ties are rare: a last-bit difference must also cross a half step
    grown = rt.grow_caches(tcfg, tc, 2, 32)["layers"][0]
    assert (grown.k.dtype, grown.k_scale.dtype, grown.k.shape[1]) == (torch.int8, torch.float32, 32)
    assert torch.equal(grown.k[:, :24], tc["layers"][0].k) and not grown.k[:, 24:].any()


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_decode_matches_jax(arch, backend):
    jcfg, tcfg, jp, tp = _model(arch, seed=2)
    b, s0, max_len = 3, 20, 32
    toks = _tokens(jcfg.vocab_size, b=b, s=s0, seed=3)
    jr = jrt.Runtime(backend=backend, bm=8, bk=16, bn=16)
    tr = trt.Runtime(backend=backend, device="cpu", bm=8, bk=16, bn=16)
    with jrt.use(jr):
        _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    tc = {"layers": [TA.KVCache(*(tensor_from_numpy(np.asarray(leaf[i])) for leaf in jc["layers"]))
                     for i in range(tcfg.num_layers)]}
    before = [c.k for c in tc["layers"]]
    rng = np.random.default_rng(4)
    pos = np.array([s0, s0 + 2, s0 + 1], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)}, torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    assert all(c.k is k for c, k in zip(tc["layers"], before))  # written in place
    for layer, cache in enumerate(tc["layers"]):
        for got, want in zip(cache, (leaf[layer] for leaf in jc["layers"])):
            want = np.asarray(want)
            if want.dtype == np.int8:
                assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
                assert (got.numpy() != want).sum() <= 1
            else:
                np.testing.assert_allclose(got.numpy(), want, **TOL)
