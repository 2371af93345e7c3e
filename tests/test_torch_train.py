"""The training slice of repro_torch against the JAX package, on the CPU.

The model is the JAX suite's ReLU language model (reduced deepseek-7b with
``activation="relu"``: 2 layers, d_model 64), parameters from the JAX
initializer through ``params_from_jax``, both packages on the ``reference``
backend at ``bm=8, bk=16, bn=16`` (never ``interpret``, ROADMAP queue 3).

Tolerances:

* fp32 parameters: loss rtol 1e-4; gradients and updated parameters rtol =
  atol = 1e-4 (``tests/test_torch_model.py``'s fp32 tolerance: the plain
  matmuls and the softmax sum in another order than XLA's).
* bf16 parameters: loss within 1e-2 relative.  Every projection rounds to
  bf16, so one flipped rounding early in a layer propagates through the rest
  of the network and the fp32 log-softmax of the rounded logits follows it;
  the logits themselves agree within 0.1 at magnitude ~4 there.
* AdamW on identical gradients: fp32 moments rtol 1e-6 (the learning rate
  and bias corrections are float32 on both sides, and an update is a few
  roundings of the same values); bf16 parameters within one bf16 ulp.
* Synthetic tokens, the tap metrics on the same inputs and the modeled
  speedup on the same densities: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import perf_model as jpm
from repro.core import sparsity as jsps
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import host_shard as jhost_shard
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax
from repro_torch.core import perf_model as tpm
from repro_torch.core import sparsity as tsps
from repro_torch.data import SyntheticLM, host_shard
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from test_torch_model import relu_lm_cfgs

GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(dtype_name="float32", seed=0, data_seed=5):
    jcfg, tcfg = relu_lm_cfgs()
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    jdata = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=data_seed)
    tdata = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=data_seed)
    return jcfg, tcfg, jp, tp, jdata, tdata


def _jax_leaves_as_port(jtree, tcfg):
    """A JAX parameter-shaped tree (params, grads, moments) in the port's
    layout, as its ``tree_leaves`` order."""
    return tadamw.tree_leaves(params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jtree), tcfg))


# ---------------------------------------------------------------------------
# data, optimizer, taps, perf model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (7, 1)])
def test_synthetic_tokens_equal_jax(seed, step):
    j = JSyntheticLM(vocab_size=102400, seq_len=130, global_batch=3, seed=seed).batch_at(step)
    t = SyntheticLM(vocab_size=102400, seq_len=130, global_batch=3, seed=seed).batch_at(step, device="cpu")
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32 and t[k].device.type == "cpu"
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for i in range(3):
        js, ts = jhost_shard(j, i, 3), host_shard(t, i, 3)
        np.testing.assert_array_equal(ts["tokens"].numpy(), np.asarray(js["tokens"]))


@pytest.mark.parametrize("step", [0, 1, 5, 100, 3000, 20000])
def test_lr_schedule_equals_jax(step):
    cfg = tadamw.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10000)
    jcfg = jadamw.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10000)
    want = float(jadamw.lr_at(jcfg, jnp.asarray(step)))
    assert tadamw.lr_at(cfg, step) == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_adamw_equals_jax_on_identical_grads(dtype_name):
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "b": (8,), "emb": (4, 16)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    cfg = dict(lr=1e-2, warmup_steps=2, clip_norm=1.0)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    jo = jadamw.init_opt_state(jp)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    to = tadamw.init_opt_state(tp)
    objs = {k: v for k, v in tp.items()}
    for g in grads:
        jp, jo, jm = jadamw.apply_updates(jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, jo,
                                          jadamw.OptConfig(**cfg))
        tp, to, tm = tadamw.apply_updates(tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, to,
                                          tadamw.OptConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert to.step == int(jo.step) == 3
    assert all(tp[k] is objs[k] for k in tp)  # updated in place, same tensors
    for k in shapes:
        np.testing.assert_allclose(to.m[k].numpy(), np.asarray(jo.m[k]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(to.v[k].numpy(), np.asarray(jo.v[k]), rtol=1e-6, atol=1e-12)
        got, want = tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32))
        if dtype_name == "bfloat16":  # one bf16 ulp: 2**-7 of the value's power of two
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_sparsity_measure_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    x[x < 0.3] = 0.0
    x[:, :, 16:32] = 0.0
    j, t = jsps.measure(jnp.asarray(x)), tsps.measure(torch.from_numpy(x))
    for a, b in zip(j, t):
        assert b.dtype == torch.float32
        assert float(b) == float(a)
    np.testing.assert_array_equal(tsps.block_mask(torch.from_numpy(x), 16, axis=1).numpy(),
                                  np.asarray(jsps.block_mask(jnp.asarray(x), 16, axis=1)))


def test_tap_metrics_and_modeled_speedup_equal_jax_bit_for_bit():
    """The train step's tap reduction on the same activation stats and
    probe gradients, and the perf model on the same densities."""
    jcfg, tcfg = relu_lm_cfgs()
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 500, size=(4, jcfg.num_layers)).astype(np.float32)
    counts[1] += counts[0]  # total >= zeros
    gprobe = rng.standard_normal((jcfg.num_layers, 2, 8, jcfg.d_model)).astype(np.float32)
    gprobe[gprobe < -0.5] = 0.0
    jstats = jsps.SparsityStats(*(jnp.asarray(c) for c in counts))
    tstats = tsps.SparsityStats(*(torch.from_numpy(c) for c in counts))
    jm = jstep._tap_metrics(jcfg, {"layers": {"ffn_act": jstats}}, {"layers": jnp.asarray(gprobe)})
    tm = tstep._tap_metrics(tcfg, {"layers": {"ffn_act": tstats}}, {"layers": torch.from_numpy(gprobe)})
    for k in ("A_density", "G_density", "modeled_speedup"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    jl = jpm.ffn_layers_from_config(jcfg, n_layers=2)
    tl = tpm.ffn_layers_from_config(tcfg, n_layers=2)
    assert [dataclasses.asdict(x) for x in tl] == [dataclasses.asdict(x) for x in jl]
    a, g = np.asarray(jm["A_density"]), np.asarray(jm["G_density"])
    kw = dict(max_t=32, sample_groups=1)
    assert tpm.speedup_from_densities(a, g, tl, device="cpu", **kw) == jpm.speedup_from_densities(a, g, jl, **kw)
    assert tstep.modeled_speedup(tm, tcfg, **kw) == jstep.modeled_speedup(jm, jcfg, **kw)


# ---------------------------------------------------------------------------
# one train step against the JAX package's
# ---------------------------------------------------------------------------


def _backward_node_names(loss):
    seen, stack, names = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


def test_planned_products_are_differentiated_by_the_functions(monkeypatch):
    """The loss graph holds one fused node per gate and one planned node per
    ``w_down`` and for the LM head, and the plain block loop only ever runs
    with autograd off (inside the Functions), forward and backward."""
    from repro_torch.kernels import ref as tref

    grad_mode = []
    orig = tref._planned_acc

    def spy(*args, **kw):
        grad_mode.append(torch.is_grad_enabled())
        return orig(*args, **kw)

    monkeypatch.setattr(tref, "_planned_acc", spy)
    _, tcfg, _, tp, _, tdata = _setup()
    for p in tadamw.tree_leaves(tp):
        p.requires_grad_(True)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        loss = TM.loss_fn(tp, tcfg, tdata.batch_at(0, device="cpu"))
    names = _backward_node_names(loss)
    assert names.count("_FusedMatmulBackward") == tcfg.num_layers
    assert names.count("_PlannedMatmulBackward") == tcfg.num_layers + 1
    loss.backward()
    # forward: L gates + L w_down + LM head; backward: two products each
    assert len(grad_mode) == 3 * (2 * tcfg.num_layers + 1) and not any(grad_mode)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_and_grads_equal_jax(microbatches):
    jcfg, tcfg, jp, tp, jdata, tdata = _setup()
    jr = jrt.Runtime(backend="reference", **GEOM)
    with jrt.use(jr):
        jloss, jgrads = jax.value_and_grad(jstep.make_loss_fn(jcfg))(jp, jdata.batch_at(0))
    for p in tadamw.tree_leaves(tp):
        p.requires_grad_(True)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(tcfg), tcfg, tp, tdata.batch_at(0, device="cpu"),
                                                microbatches=microbatches)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    for g, jg in zip(grads, _jax_leaves_as_port(jgrads, tcfg)):
        np.testing.assert_allclose(g.float().numpy(), jg.float().numpy(), **TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_jax_fp32(microbatches):
    jcfg, tcfg, jp, tp, jdata, tdata = _setup()
    jr = jrt.Runtime(backend="reference", **GEOM)
    with jrt.use(jr):
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), microbatches=microbatches,
                                            sparsity_taps=True))
        jp2, jo2, jm = jfn(jp, jadamw.init_opt_state(jp), jdata.batch_at(0))
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    with tr.use():
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), microbatches=microbatches,
                                   sparsity_taps=True)
        opt = tstep.init_train_state(tcfg, tp)
        tp2, to2, tm = fn(tp, opt, tdata.batch_at(0, device="cpu"))
    assert tp2 is tp and to2.step == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for t, j in zip(tadamw.tree_leaves(tp2), _jax_leaves_as_port(jp2, tcfg)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), **TOL)
    for t, j in zip(tadamw.tree_leaves(to2.m), _jax_leaves_as_port(jo2.m, tcfg)):
        np.testing.assert_allclose(t.numpy(), j.numpy(), **TOL)
    # taps: the same activations and probe gradients up to fp32 order, so
    # the zero counts agree to within one element of a layer's tensor
    b, s = tdata.batch_at(0, device="cpu")["tokens"].shape
    one = 1.0 / (b * s * tcfg.d_ff)
    np.testing.assert_allclose(tm["A_density"].numpy(), np.asarray(jm["A_density"]), rtol=0, atol=one)
    np.testing.assert_allclose(tm["G_density"].numpy(), np.asarray(jm["G_density"]), rtol=0,
                               atol=1.0 / (b * s * tcfg.d_model))
    assert np.all(tm["A_density"].numpy() < 0.95)  # ReLU activations are sparse from step one
    sim = tstep.modeled_speedup(tm, tcfg, max_t=32, sample_groups=1)
    assert sim["overall"] >= 1.0


def test_train_step_bf16_loss_near_jax():
    jcfg, tcfg, jp, tp, jdata, tdata = _setup("bfloat16")
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), microbatches=2))
        _, _, jm = jfn(jp, jadamw.init_opt_state(jp), jdata.batch_at(0))
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), microbatches=2)
        tp2, _, tm = fn(tp, tstep.init_train_state(tcfg, tp), tdata.batch_at(0, device="cpu"))
    assert tadamw.tree_leaves(tp2)[0].dtype == torch.bfloat16
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)


#: MoE configs whose first block is dense, so the zero probes and the taps
#: span two stacks (``dense_layers`` ahead of ``layers``): reduced qwen3-moe
#: with a dense first block and a shared expert (``test_torch_moe``'s
#: ``relu-dense1-shared``), and reduced deepseek-v2 (MLA, a dense first block,
#: MoE with a shared expert), both with a ReLU gate
MOE_TRAIN = {
    "qwen3-moe-relu-dense1-shared": ("qwen3-moe-235b-a22b", dict(
        activation="relu", num_layers=3, first_dense_layers=1, num_shared_experts=1, d_ff=128)),
    "deepseek-v2-relu": ("deepseek-v2-236b", dict(activation="relu")),
}
#: fp32 bound of the MoE step (ROADMAP queue 3's runtime-level bound)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
#: AdamW's first step moves a parameter by ``lr * g / (|g| + eps)``: where
#: ``|g|`` is within a few ``eps`` of zero, a difference of 1e-10 in ``g`` (the
#: products' fp32 summation order) moves the parameter by ~1e-5.  Parameters
#: are held to MOE_TOL where ``|g| >= WELL_CONDITIONED`` (there the update's
#: slope ``eps / (|g| + eps)**2`` is below 1e4, so a gradient difference of
#: 1e-9 moves the parameter by less than 1e-8) or both gradients are zero
#: (an expert no token reached), and within the update's range, ``2 * lr``,
#: elsewhere
WELL_CONDITIONED = 100 * tadamw.OptConfig().eps


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("model", list(MOE_TRAIN))
def test_moe_train_step_with_taps_equals_jax(model, microbatches):
    """One ``sparsity_taps`` step of a MoE config with a dense first block:
    loss, gradients (each microbatch's own routing and capacity, so JAX's
    gradients are taken per microbatch and averaged), first moments and the
    updated parameters (see ``WELL_CONDITIONED``) within ``MOE_TOL``; one A
    and one G density per layer, dense block first, equal to JAX's, and the
    modeled speedup with them."""
    arch, kw = MOE_TRAIN[model]
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg) and tcfg.first_dense_layers == 1
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    jbatch = JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=5).batch_at(0)
    tbatch = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4, seed=5).batch_at(0, device="cpu")
    per = 4 // microbatches
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        grad_fn = jax.value_and_grad(jstep.make_loss_fn(jcfg))
        parts = [grad_fn(jp, {k: v[i * per:(i + 1) * per] for k, v in jbatch.items()})
                 for i in range(microbatches)]
        jloss = sum(float(l) for l, _ in parts) / microbatches
        jgrads = jax.tree.map(lambda *g: sum(g) / microbatches, *(g for _, g in parts))
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), microbatches=microbatches,
                                            sparsity_taps=True))
        jp2, jo2, jm = jfn(jp, jadamw.init_opt_state(jp), jbatch)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        loss, grads, taps = tstep.accumulate_grads(tstep.make_loss_fn(tcfg), tcfg, tp, tbatch,
                                                   microbatches=microbatches, sparsity_taps=True)
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), microbatches=microbatches,
                                   sparsity_taps=True)
        tp2, to2, tm = fn(tp, tstep.init_train_state(tcfg, tp), tbatch)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    for g, jg in zip(grads, _jax_leaves_as_port(jgrads, tcfg)):
        np.testing.assert_allclose(g.float().numpy(), jg.numpy(), **MOE_TOL)
    for t, j in zip(tadamw.tree_leaves(to2.m), _jax_leaves_as_port(jo2.m, tcfg)):
        np.testing.assert_allclose(t.numpy(), j.numpy(), **MOE_TOL)
    conditioned = 0
    for t, j, g, jg in zip(tadamw.tree_leaves(tp2), _jax_leaves_as_port(jp2, tcfg), grads,
                           _jax_leaves_as_port(jgrads, tcfg)):
        t, j, g, jg = t.detach().numpy(), j.numpy(), g.float().numpy(), jg.numpy()
        well = (np.abs(jg) >= WELL_CONDITIONED) | ((g == 0) & (jg == 0))
        np.testing.assert_allclose(t[well], j[well], **MOE_TOL)
        np.testing.assert_array_less(np.abs(t - j), 2 * OPT["lr"])
        conditioned += int(well.sum())
    assert conditioned > 0.98 * sum(p.numel() for p in tadamw.tree_leaves(tp2))
    for k in ("A_density", "G_density"):
        assert tuple(tm[k].shape) == tuple(taps[k].shape) == (tcfg.num_layers,)
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    assert float(tm["modeled_speedup"]) == pytest.approx(float(jm["modeled_speedup"]), rel=1e-6)
    kw = dict(max_t=32, sample_groups=1)
    assert tstep.modeled_speedup(tm, tcfg, **kw) == jstep.modeled_speedup(jm, jcfg, **kw)


def test_plan_cache_counts_over_training_steps():
    """The three kinds of entry (tests/test_backward_planned.py:104-146 for
    JAX): the LM-head weight plan, rebuilt once per step after the in-place
    update and hit on the second microbatch; the transposed plans, hit from
    the second microbatch on for the (memoized) dense gate plan and the LM
    head; the cotangent plans and the emitted-mask transposes, fresh every
    call."""
    _, tcfg, _, tp, _, tdata = _setup()
    rt = trt.Runtime(backend="reference", device="cpu", **GEOM)
    L, mb = tcfg.num_layers, 2
    with rt.use():
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), microbatches=mb)
        opt = tstep.init_train_state(tcfg, tp)
        prev = {"hits": 0, "misses": 0}
        for step in range(3):
            tp, opt, _ = fn(tp, opt, tdata.batch_at(step, device="cpu"))
            s = rt.plan_cache.stats()
            hits, misses = s["hits"] - prev["hits"], s["misses"] - prev["misses"]
            prev = s
            first = int(step == 0)  # the dense gate plan's transpose, built once per run
            # head plan 1 hit; gate lhs-T L*mb - first hits; head lhs-T 1 hit
            assert hits == 1 + (L * mb - first) + 1, (step, s)
            # head plan 1; gate lhs-T first; w_down lhs-T L*mb; head lhs-T 1;
            # cotangents: w_down L*mb, LM head mb
            assert misses == 1 + first + L * mb + 1 + L * mb + mb, (step, s)


def test_remat_recomputes_to_the_same_gradients():
    """``cfg.remat`` checkpoints each layer: the same loss and gradients bit
    for bit, the forward products run again in the backward, and anomaly
    detection finds no in-place write to a saved tensor."""
    _, tcfg, _, tp, _, tdata = _setup()
    batch = tdata.batch_at(1, device="cpu")
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        spy = {"fused": 0}
        orig = trt.get_backend("reference").execute_fused

        def counted(req, orig=orig):
            spy["fused"] += 1
            return orig(req)

        backend = trt.get_backend("reference")
        backend.execute_fused = counted
        try:
            with trt.Runtime(backend="reference", device="cpu", **GEOM).use(), \
                    torch.autograd.set_detect_anomaly(True):
                for p in tadamw.tree_leaves(tp):
                    p.requires_grad_(True)
                loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, tp, batch)
        finally:
            del backend.execute_fused
        out[remat] = (loss, grads, spy["fused"])
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    assert out[False][2] == tcfg.num_layers and out[True][2] == 2 * tcfg.num_layers


@pytest.mark.parametrize("poison", [1, 2])
def test_guard_nonfinite_skips_a_poisoned_step(poison):
    _, tcfg, _, tp, _, tdata = _setup()
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), guard_nonfinite=True)
        opt = tstep.init_train_state(tcfg, tp)
        tp, opt, m0 = fn(tp, opt, tdata.batch_at(0, device="cpu"), poison=0)
        assert m0["nonfinite"] == 0 and opt.step == 1
        before = [p.detach().clone() for p in tadamw.tree_leaves(tp)]
        moments = [m.clone() for m in tadamw.tree_leaves(opt.m)]
        tp, opt2, m1 = fn(tp, opt, tdata.batch_at(1, device="cpu"), poison=poison)
    assert m1["nonfinite"] == 1 and opt2.step == 1
    assert all(torch.equal(a, b) for a, b in zip(before, tadamw.tree_leaves(tp)))
    assert all(torch.equal(a, b) for a, b in zip(moments, tadamw.tree_leaves(opt2.m)))


def test_guarded_clean_step_equals_unguarded_and_options_refuse():
    _, tcfg, jp, tp, _, tdata = _setup()
    tq = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)  # a second copy of the same params
    batch = tdata.batch_at(0, device="cpu")
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        a, _, ma = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), guard_nonfinite=True)(
            tp, tstep.init_train_state(tcfg, tp), batch)
        b, _, mb = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT))(
            tq, tstep.init_train_state(tcfg, tq), batch)
        dyn = tstep.make_train_step(tcfg, tadamw.OptConfig(), dynamic_sparsity={"['lm_head']": (16, 16)})
        with pytest.raises(TypeError, match="masks"):  # a dynamic step refuses to run without masks
            dyn(tq, tstep.init_train_state(tcfg, tq), batch)
    assert float(ma["loss"]) == float(mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tadamw.tree_leaves(a), tadamw.tree_leaves(b)))
