"""repro_torch.models.moe (and the MoE family of the backbone) against
repro.models.moe on the CPU.

The same seeded numpy inputs and the JAX initializer's weights (carried
across by ``params_from_jax`` / ``tensor_from_numpy``) go through both
packages; the JAX side runs under ``reference`` or ``dense``, never
``interpret``.

* Routing and capacity bucketing are integer work: top-k experts, the slot
  table, positions and fits are equal exactly, with ample and with
  dropping capacity.
* ``moe_ffn`` under ``dense`` and ``reference``, fp32 and bf16, ReLU and
  SiLU, with and without a shared expert: within
  ``test_torch_model.TOL`` (fp32 rtol = atol = 1e-4; bf16 atol 0.1).
* The JAX suite's loop-over-experts oracle, on the port.
* Under ``reference`` with a ReLU gate each expert's ``w_down`` product is
  planned from its values: an expert no token reached sees only the
  all-zero pad row, so its plan has no effectual block and its output rows
  are zero.
* ``init_params``: JAX's fan-in rule (``[E, d, f]`` draws std
  ``1/sqrt(d)``), the fp32 router at std 0.02, and 1-D / 2-D draws as JAX draws them.
* Reduced qwen3-moe-235b-a22b (ReLU, SiLU, and a variant with
  ``first_dense_layers=1`` of 3 layers, a shared expert and ``d_ff=128``): ``forward``,
  ``prefill`` and per-row-``pos`` ``decode_step`` logits within ``TOL``,
  and a ``params_from_jax`` round trip of the MoE tree.
* Reduced qwen3-moe with MLA attention (the family no longer refuses it):
  ``forward`` and ``prefill`` within ``TOL``.
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
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.common import _fan_in as jfan_in
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.common import Spec, _fan_in, init_params
from repro_torch.runtime import runtime as trt_runtime
from test_torch_model import TOL

GEOM = dict(bm=8, bk=16, bn=16)
ARCH = "qwen3-moe-235b-a22b"
#: the reduced model's variants: the registered SiLU, its ReLU variant (every
#: expert's w_down planned under reference), and one with a dense first
#: block ahead of the two MoE blocks (``reduce_config``'s ``2 +
#: first_dense_layers``) and a shared expert
VARIANTS = {
    "silu": {},
    "relu": dict(activation="relu"),
    "relu-dense1-shared": dict(activation="relu", num_layers=3, first_dense_layers=1,
                               num_shared_experts=1, d_ff=128),
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _moe(dtype_name="float32", seed=0, **kw):
    """(JAX MoEConfig, port MoEConfig, JAX params, port params)."""
    jcfg = JMoE.MoEConfig(**{**dict(d_model=16, num_experts=8, top_k=2, d_ff=32), **kw})
    tcfg = TMoE.MoEConfig(**dataclasses.asdict(jcfg))
    jp = jinit_params(JMoE.moe_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x)), jp)
    return jcfg, tcfg, jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(j, t, dtype_name):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


# ---------------------------------------------------------------------------
# routing and bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", ["ample", "dropping", "one"])
@pytest.mark.parametrize("seed", [0, 1])
def test_route_and_bucket_match_jax_exactly(capacity, seed):
    jcfg, tcfg, jp, tp = _moe(seed=seed)
    x2 = _x((24, 16), seed)
    t = x2.shape[0]
    cap = {"ample": t * jcfg.top_k, "dropping": 3, "one": 1}[capacity]
    jw, je, jprobs = JMoE._route(jcfg, jnp.asarray(x2), jp["router"])
    tw, te, tprobs = TMoE._route(tcfg, torch.from_numpy(x2), tp["router"])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    jtab, jpos, jfits = JMoE._bucket(jcfg, je, jcfg.num_experts, cap, t)
    ttab, tpos, tfits = TMoE._bucket(tcfg, te, tcfg.num_experts, cap, t)
    for got, want in ((ttab, jtab), (tpos, jpos), (tfits, jfits)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = int((~tfits).sum())
    assert (dropped == 0) == (capacity == "ample")


def test_router_is_structured_sparsity():
    """Exactly top_k of num_experts slots effectual per token, weights
    summing to one (the JAX suite's test, on the port)."""
    _, tcfg, _, tp = _moe(seed=2)
    top_p, top_e, _ = TMoE._route(tcfg, torch.from_numpy(_x((24, 16), 3)), tp["router"])
    onehot = torch.nn.functional.one_hot(top_e, tcfg.num_experts).sum(dim=1)
    assert int(onehot.sum()) == 24 * 2 and int(onehot.max()) == 1
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("activation", ["relu", "silu"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_moe_ffn_matches_jax(backend, dtype_name, activation, shared):
    jcfg, tcfg, jp, tp = _moe(dtype_name, seed=3, activation=activation, num_shared_experts=shared)
    x = _x((2, 10, 16), 4)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype_name))
    with jrt.use(jrt.Runtime(backend=backend, **GEOM)):
        want = JMoE.moe_ffn(jp, jcfg, jx)
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        got = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(x).to(getattr(torch, dtype_name)))
    assert got.dtype == getattr(torch, dtype_name) and tuple(got.shape) == (2, 10, 16)
    _close(want, got, dtype_name)


def _oracle(tp, cfg, x2):
    """Every token through its top-k experts, no capacity (the JAX suite's
    loop-over-experts oracle, in numpy on the port's routing)."""
    top_p, top_e, _ = TMoE._route(cfg, torch.from_numpy(x2), tp["router"])
    act = {"silu": lambda v: v / (1 + np.exp(-v)), "relu": lambda v: np.maximum(v, 0)}[cfg.activation]
    wg, wu, wd = (tp[k].numpy().astype(np.float64) for k in ("w_gate", "w_up", "w_down"))
    y = np.zeros_like(x2, dtype=np.float64)
    for t in range(x2.shape[0]):
        for j in range(cfg.top_k):
            e = int(top_e[t, j])
            h = act(x2[t] @ wg[e]) * (x2[t] @ wu[e])
            y[t] += float(top_p[t, j]) * (h @ wd[e])
    return y


@pytest.mark.parametrize("activation", ["silu", "relu"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_moe_matches_oracle_with_ample_capacity(backend, activation):
    _, tcfg, _, tp = _moe(seed=0, num_experts=4, capacity_factor=8.0, activation=activation)
    x2 = _x((12, 16), 1)
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        y = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(x2)[None])
    np.testing.assert_allclose(y[0].numpy(), _oracle(tp, tcfg, x2), rtol=2e-3, atol=2e-3)


def test_capacity_drop_is_graceful():
    _, tcfg, _, tp = _moe(seed=0, num_experts=2, top_k=1, d_ff=8, capacity_factor=0.25)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        y = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(_x((1, 16, 16), 1)))
    assert bool(torch.isfinite(y).all())


def test_an_expert_no_token_reached_gets_an_empty_plan(monkeypatch):
    """Under ``reference`` with a ReLU gate each expert's ``w_down`` is one
    planned product over ``h[e]``; an expert whose slots all hold the pad row
    plans no effectual block and writes zero rows."""
    _, tcfg, _, tp = _moe(seed=5, num_experts=8, top_k=1, activation="relu")
    plans, outs = [], []
    plan_operand, expert_ffn = trt_runtime.plan_operand, TMoE._expert_ffn
    monkeypatch.setattr(trt_runtime, "plan_operand",
                        lambda a, *args, **kw: plans.append(plan_operand(a, *args, **kw)) or plans[-1])
    monkeypatch.setattr(TMoE, "_expert_ffn",
                        lambda *args, **kw: outs.append(expert_ffn(*args, **kw)) or outs[-1])
    x2 = _x((4, 16), 6)  # 4 tokens, top-1 of 8 experts: at least 4 experts get none
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        y = TMoE.moe_ffn(tp, tcfg, torch.from_numpy(x2)[None])
    _, top_e, _ = TMoE._route(tcfg, torch.from_numpy(x2), tp["router"])
    idle = sorted(set(range(8)) - set(top_e.flatten().tolist()))
    assert len(idle) >= 4 and len(plans) == 8 and len(outs) == 1
    cap = max(1, int(4 * 1 / 8 * 1.25))
    for e, plan in enumerate(plans):
        assert plan.shape == (cap, tcfg.d_ff)
        if e in idle:
            assert int(plan.nnz.sum()) == 0 and plan.effectual_blocks() == 0
            assert not bool(outs[0][e].any())
        else:
            assert plan.effectual_blocks() > 0
    assert bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (16, 8), (4, 16, 8), (3, 5, 16, 8)])
def test_fan_in_is_jax_rule(shape):
    assert _fan_in(shape) == jfan_in(shape)


def test_init_params_expert_fan_in_and_fp32_router():
    cfg = TMoE.MoEConfig(d_model=256, num_experts=4, top_k=2, d_ff=64, num_shared_experts=1)
    p = init_params(TMoE.moe_specs(cfg), seed=0, dtype=torch.bfloat16, device="cpu")
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert p["shared"]["w_down"].dtype == torch.bfloat16
    # [E, d, f]: fan-in d = 256 (std 0.0625), not E = 4 (std 0.5); [E, f, d]: f = 64
    for name, std in (("w_gate", 1 / 16), ("w_up", 1 / 16), ("w_down", 1 / 8), ("router", 0.02)):
        assert abs(float(p[name].float().std()) / std - 1) < 0.03, name
    assert abs(float(p["shared"]["w_down"].float().std()) * math.sqrt(64) - 1) < 0.03


def test_init_params_dense_draws_unchanged():
    """1-D and 2-D specs draw as JAX's ``init_params`` draws them: one key a
    leaf from ``split(PRNGKey(4), 4)`` in sorted key order, N(0,
    1/shape[0]) for ``normal``, N(0, 1) for ``embed``."""
    specs = {"ln": Spec((8,), init="ones"), "w": Spec((16, 8)), "e": Spec((32, 16), init="embed"),
             "v": Spec((5,))}
    p = init_params(specs, seed=4, dtype=torch.float32, device="cpu")
    k_e, _, k_v, k_w = (jax.random.split(jax.random.PRNGKey(4), 4))  # sorted: e, ln, v, w
    draw = lambda k, shape: torch.from_numpy(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    w = draw(k_w, (16, 8)) * np.float32(1 / 4.0)
    e = draw(k_e, (32, 16))
    v = draw(k_v, (5,)) * np.float32(1 / math.sqrt(5))
    assert torch.equal(p["ln"], torch.ones(8))
    assert torch.equal(p["w"], w) and torch.equal(p["e"], e) and torch.equal(p["v"], v)


# ---------------------------------------------------------------------------
# the MoE family in the backbone: reduced qwen3-moe-235b-a22b
# ---------------------------------------------------------------------------


def _model(variant, dtype_name, seed=0):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(ARCH)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(ARCH)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_model_forward_and_prefill_match_jax(variant, backend, dtype_name):
    jcfg, tcfg, jp, tp = _model(variant, dtype_name)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    with jrt.use(jrt.Runtime(backend=backend, **GEOM)):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        jpl, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        taps = {}
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, taps=taps)
        tpl, tcaches = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (3, 12, jcfg.vocab_size) and tpl.shape == (3, 1, jcfg.vocab_size)
    _close(jl, tl, dtype_name)
    _close(jpl, tpl, dtype_name)
    stacks = {"layers": 2} | ({"dense_layers": 1} if tcfg.first_dense_layers else {})
    assert {k: len(v) for k, v in tcaches.items()} == stacks
    assert {k: int(v["ffn_act"].total.shape[0]) for k, v in taps.items()} == stacks


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_model_decode_with_per_row_pos_matches_jax(variant, backend, dtype_name):
    jcfg, tcfg, jp, tp = _model(variant, dtype_name, seed=1)
    rng = np.random.default_rng(2)
    b, s0, max_len, steps = 3, 6, 16, 3
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, s0)).astype(np.int32)
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)})
        jc = jr.grow_caches(jcfg, jc, b, max_len)
        jstep = jax.jit(lambda p, c, t, q: JM.decode_step(p, jcfg, c, {"tokens": t}, q))
    with tr.use():
        _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
        tc = tr.grow_caches(tcfg, tc, b, max_len)
    pos = np.array([s0, s0 + 1, s0 + 3], np.int32)
    for _ in range(steps):
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
            jk = np.asarray(jc[stack].k[layer].astype(jnp.float32))
            np.testing.assert_allclose(cache.k.float().numpy(), jk, **TOL[dtype_name])


def test_convert_round_trips_the_moe_tree():
    jcfg, tcfg, jp, tp = _model("relu-dense1-shared", "bfloat16")
    assert sorted(tp) == ["dense_layers", "embed", "final_norm", "layers", "lm_head"]
    assert len(tp["layers"]) == 2 and len(tp["dense_layers"]) == 1
    mlp = tp["layers"][1]["mlp"]
    assert sorted(mlp) == ["router", "shared", "w_down", "w_gate", "w_up"]
    assert mlp["router"].dtype == torch.float32 and mlp["w_down"].dtype == torch.bfloat16
    assert mlp["w_gate"].shape == (tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff)
    for got, want in ((mlp["w_down"], jp["layers"]["mlp"]["w_down"][1]),
                      (mlp["router"], jp["layers"]["mlp"]["router"][1]),
                      (mlp["shared"]["w_up"], jp["layers"]["mlp"]["shared"]["w_up"][1]),
                      (tp["dense_layers"][0]["mlp"]["w_gate"], jp["dense_layers"]["mlp"]["w_gate"][0])):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the port's own spec tree has the same structure, shapes and dtypes
    mine = init_params(TM.param_specs(tcfg), seed=0, dtype=torch.bfloat16, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)
    assert shapes(mine) == shapes(tp)


#: MLA widths of the reduced deepseek-v2 config (``reduce_config``)
MLA_KW = dict(use_mla=True, kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16)


@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_moe_family_runs_mla(backend):
    """Reduced qwen3-moe with MLA attention: MLA's spec tree in every block
    and ``forward``/``prefill`` logits within ``TOL`` of JAX's (fp32)."""
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(ARCH)), activation="relu", **MLA_KW)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(ARCH)), activation="relu", **MLA_KW)
    specs = TM.param_specs(tcfg)
    assert sorted(specs["layers"][0]["attn"]) == ["kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    with jrt.use(jrt.Runtime(backend=backend, **GEOM)):
        jl = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        jpl, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        tl = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        tpl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(jl, tl, "float32")
    _close(jpl, tpl, "float32")
    assert tuple(tc["layers"][0].c_kv.shape) == (2, 10, 32)
