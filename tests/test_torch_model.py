"""repro_torch.models against repro.models on the CPU.

The model is the JAX suite's ReLU language model (``_relu_lm_cfg`` of
``test_backward_planned``: reduced deepseek-7b with ``activation="relu"``,
2 layers, d_model 64), so under ``reference`` the FFN takes the fused
emitted-mask path and the LM head the cached side-B plan.  Parameters come
from the JAX initializer through ``params_from_jax``.  Logits of
``forward``, ``prefill`` and four ``decode_step`` calls with a per-row
``pos`` are compared under ``dense`` and ``reference`` at ``bm=8, bk=16,
bn=16``.

Tolerances:

* fp32 parameters: rtol = atol = 1e-4.  The plain matmuls and the softmax
  sum in another order than XLA's; the bf16 KV cache rounds K/V, and a
  last-bit difference before that rounding can flip a bf16 value.
* bf16 parameters: atol = 0.1 at logits of magnitude ~4 (largest measured
  difference 0.035, about two bf16 steps at that magnitude): every
  projection rounds to bf16, so one flipped rounding early in a layer
  propagates through the rest of the network.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro_torch import runtime as trt
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM

GEOM = dict(bm=8, bk=16, bn=16)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.0, atol=0.1)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def relu_lm_cfgs():
    """(JAX config, port config) of the JAX suite's ReLU language model."""
    j = dataclasses.replace(jreduce_config(jget_config("deepseek-7b")), activation="relu")
    t = dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _setup(dtype_name, seed=0):
    jcfg, tcfg = relu_lm_cfgs()
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _close(j, t, dtype_name):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_forward_and_prefill_logits_match_jax(backend, dtype_name):
    jcfg, tcfg, jp, tp = _setup(dtype_name)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        jpl, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with tr.use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        tpl, tcaches = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (3, 12, jcfg.vocab_size) and tpl.shape == (3, 1, jcfg.vocab_size)
    _close(jl, tl, dtype_name)
    _close(jpl, tpl, dtype_name)
    assert len(tcaches["layers"]) == tcfg.num_layers


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_decode_steps_with_per_row_pos_match_jax(backend, dtype_name):
    jcfg, tcfg, jp, tp = _setup(dtype_name, seed=1)
    rng = np.random.default_rng(2)
    b, s0, max_len, steps = 3, 6, 16, 4
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, s0)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)})
        jc = jr.grow_caches(jcfg, jc, b, max_len)
    with tr.use():
        _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    assert tc["layers"][0].k.dtype == torch.bfloat16  # bf16 whatever the params
    pos = np.array([s0, s0 + 1, s0 + 3], np.int32)  # each row at its own position
    with jrt.use(jr):  # one compiled JAX step, replayed (the runtime is read at trace time)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        with jrt.use(jr):
            jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos).long())
        _close(jl, tl, dtype_name)
        pos = pos + 1
    for layer in range(tcfg.num_layers):
        jk = np.asarray(jc["layers"].k[layer].astype(jnp.float32))
        np.testing.assert_allclose(tc["layers"][layer].k.float().numpy(), jk, **TOL[dtype_name])


def test_convert_round_trips_bf16_exactly():
    jcfg, tcfg, jp, tp = _setup("bfloat16")
    assert tp["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["lm_head"].float().numpy(),
                                  np.asarray(jp["lm_head"].astype(jnp.float32)))
    w = np.asarray(jp["layers"]["mlp"]["w_down"][1].astype(jnp.float32))
    np.testing.assert_array_equal(tp["layers"][1]["mlp"]["w_down"].float().numpy(), w)


def test_port_init_is_seeded_and_shaped():
    _, tcfg = relu_lm_cfgs()
    from repro_torch.models.common import init_params

    p1 = init_params(TM.param_specs(tcfg), seed=3, dtype=torch.float32, device="cpu")
    p2 = init_params(TM.param_specs(tcfg), seed=3, dtype=torch.float32, device="cpu")
    assert torch.equal(p1["lm_head"], p2["lm_head"])
    assert p1["layers"][0]["mlp"]["w_gate"].shape == (tcfg.d_model, tcfg.d_ff)
    assert len(p1["layers"]) == tcfg.num_layers
    assert torch.equal(p1["layers"][1]["ln1"], torch.ones(tcfg.d_model))
