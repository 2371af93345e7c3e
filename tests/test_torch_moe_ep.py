"""The expert-parallel MoE and the compressed gradient sum on 4 CPU ranks,
against the JAX package's sharded versions.

One pool of 4 spawned ranks per module (``repro_torch.parallel.rehearsal``:
gloo, a file rendezvous, a 60 s process-group timeout, a deadline per
task) on a ``(data 2, model 2)`` mesh; the JAX side runs in the test
process on ``Mesh(devices[:4].reshape(2, 2), ("data", "model"))`` of the
8 host devices ``tests/conftest.py`` forces.  ``MoEConfig(d_model=16,
num_experts=8, top_k=2, d_ff=32, activation="relu")``, fp32:

* ``moe_ffn(mesh=...)``, the sequence-split branch (x ``[4, 8, 16]``) and
  the decode branch (x ``[4, 1, 16]``), with ``a2a_quant`` off and on, on
  the port's ``dense`` and ``reference`` backends, against JAX's sharded
  ``moe_ffn`` on the same weights: within rtol = atol = 1e-5 without the
  int8 payload, and within two int8 steps of the largest output (2/127 of
  it) with it: both packages quantize the same rows, but a value within
  rounding of a half step can round to the other int8 level;
* at ``capacity_factor`` 8, where no shard drops a token, the sharded layer
  within 1e-5 of the unsharded port (JAX's counts capacity per shard, so at
  1.25 the two differ, as they do in the JAX package); the ranks' decode
  local steps summed by hand equal the ``all_reduce``'s result;
* the quantized and the plain all-to-all and their gradients (the mirrored
  all-to-all) against JAX's ``custom_vjp`` under ``shard_map``; the layer's
  gradients (each rank's shard's contribution) summed over the ranks
  against the unsharded layer's at ``capacity_factor`` 8;
* ``ef_compress_grads`` over the ``pod`` axis of a ``(pod 2, data 2)`` mesh
  against JAX's under ``shard_map``, sums and residuals.

The module imports no JAX at its top, so the ranks stay light.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.models import moe as TMoE
from repro_torch.optim import compress as TC
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.parallel.sharding import ShardingPolicy, axis_group
from repro_torch.runtime import Runtime

MESH = ((2, 2), ("data", "model"))
CFG = dict(d_model=16, num_experts=8, top_k=2, d_ff=32, activation="relu")
TOL = dict(rtol=1e-5, atol=1e-5)
GEOM = dict(bm=8, bk=16, bn=16)


def _params(seed=0):
    """The JAX initializer's MoE weights (fp32), as numpy."""
    import jax

    from repro.models import moe as JMoE
    from repro.models.common import init_params as jinit_params

    jp = jinit_params(JMoE.moe_specs(JMoE.MoEConfig(**CFG)), jax.random.PRNGKey(seed), dtype=np.float32)
    return {k: np.asarray(v) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_mesh(names=("data", "model")):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), names)


def _jax_moe(cfg_kw, params, x, seq_sharded):
    import jax.numpy as jnp

    from repro.models import moe as JMoE

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y = JMoE.moe_ffn(jp, JMoE.MoEConfig(**cfg_kw), jnp.asarray(x), mesh=_jax_mesh(), seq_sharded=seq_sharded)
    return np.asarray(y)


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def _runtime(backend):
    return Runtime(backend=backend, device="cpu", **GEOM)


def task_moe(cfg_kw, params, x, seq_sharded, backend):
    cfg = TMoE.MoEConfig(**cfg_kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    rt = _runtime(backend)
    y = TMoE.moe_ffn(tp, cfg, xt, rt=rt, mesh=mesh(*MESH), seq_sharded=seq_sharded)
    # the runtime's policy carries the mesh as well
    y_rt = TMoE.moe_ffn(tp, cfg, xt, rt=rt.replace(sharding=ShardingPolicy(mesh=mesh(*MESH))),
                        seq_sharded=seq_sharded)
    return y.numpy(), torch.equal(y, y_rt), TMoE.moe_ffn(tp, cfg, xt, rt=rt).numpy()


def task_decode_pieces(cfg_kw, params, x):
    """The decode branch's all_reduce against the ranks' local steps summed
    by hand (what one card runs for every rank in turn)."""
    cfg = TMoE.MoEConfig(**cfg_kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x2 = torch.from_numpy(x).reshape(-1, x.shape[-1])
    y = TMoE.moe_ffn(tp, cfg, torch.from_numpy(x), rt=_runtime("reference"), mesh=mesh(*MESH),
                     seq_sharded=False).reshape(x2.shape)
    e_local = cfg.num_experts // 2
    pieces = [TMoE.decode_local_step(cfg, s, 2, {**tp, **{k: tp[k][s * e_local:(s + 1) * e_local]
                                                          for k in ("w_gate", "w_up", "w_down")}},
                                     x2, rt=_runtime("reference")) for s in range(2)]
    return float((y - (pieces[0] + pieces[1])).abs().max())


def task_a2a(x, w, quant):
    r = dist.get_rank()
    xl = torch.from_numpy(x[r]).requires_grad_()
    group = axis_group(mesh(*MESH), ("model",))[0]
    if quant:
        y = TMoE._quantized_all_to_all(xl, 0, 1, group)
    else:
        y = TMoE._AllToAll.apply(xl, 0, 1, group, False)
    (y * torch.from_numpy(w[r])).sum().backward()
    return y.detach().numpy(), xl.grad.numpy()


def task_grad(cfg_kw, params, x):
    """The gradients of ``sum(moe_ffn(mesh))`` on this rank, and the
    unsharded layer's."""
    cfg = TMoE.MoEConfig(**cfg_kw)
    out = []
    for m in (mesh(*MESH), None):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        TMoE.moe_ffn(tp, cfg, torch.from_numpy(x), rt=_runtime("dense"), mesh=m).sum().backward()
        out.append({k: v.grad.numpy() for k, v in tp.items()})
    return out


def task_compress(grads, residuals):
    r = dist.get_rank()
    pod = axis_group(mesh((2, 2), ("pod", "data")), ("pod",))[0]
    g = {k: torch.from_numpy(v[r]) for k, v in grads.items()}
    res = {k: torch.from_numpy(v[r]) for k, v in residuals.items()}
    red, new = TC.ef_compress_grads(g, res, group=pod)
    return {k: v.numpy() for k, v in red.items()}, {k: v.numpy() for k, v in new.items()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def params():
    return _params()


def _within(got, want, quant):
    if quant:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 / 127 * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def jax_sharded(params):
    """JAX's sharded ``moe_ffn`` per (branch, quant), run once each (every
    eager ``shard_map`` call compiles)."""
    memo = {}

    def get(branch, quant):
        if (branch, quant) not in memo:
            x = _x((4, 8, 16) if branch == "seq" else (4, 1, 16))
            memo[branch, quant] = x, _jax_moe({**CFG, "a2a_quant": quant}, params, x, branch == "seq")
        return memo[branch, quant]

    return get


@pytest.mark.parametrize("quant", [False, True], ids=["plain-a2a", "int8-a2a"])
@pytest.mark.parametrize("branch", ["seq", "decode"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_expert_parallel_moe_matches_jax_sharded(pool, params, jax_sharded, backend, branch, quant):
    cfg_kw = {**CFG, "a2a_quant": quant}
    x, want = jax_sharded(branch, quant)
    results = pool.run(task_moe, cfg_kw, params, x, branch == "seq", backend)
    for y, same_via_runtime, _ in results:
        assert same_via_runtime
        np.testing.assert_array_equal(y, results[0][0])  # every rank holds the global output
        _within(y, want, quant and branch == "seq")  # decode sends no payload


@pytest.mark.parametrize("branch", ["seq", "decode"])
def test_expert_parallel_moe_equals_unsharded_where_nothing_drops(pool, params, branch):
    cfg_kw = {**CFG, "a2a_quant": False, "capacity_factor": 8.0}
    x = _x((4, 8, 16) if branch == "seq" else (4, 1, 16), seed=2)
    for y, _, unsharded in pool.run(task_moe, cfg_kw, params, x, branch == "seq", "reference"):
        np.testing.assert_allclose(y, unsharded, **TOL)


def test_decode_local_steps_sum_to_the_all_reduce(pool, params):
    errs = pool.run(task_decode_pieces, {**CFG, "capacity_factor": 8.0}, params, _x((4, 1, 16), seed=3))
    assert max(errs) <= 1e-6, errs


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_all_to_all_and_its_gradient_match_jax(pool, quant):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.models import moe as JMoE

    x, w = _x((4, 4, 3, 5), seed=4), _x((4, 2, 6, 5), seed=5)
    a2a = (lambda t: JMoE._quantized_all_to_all(t, 0, 1)) if quant else (
        lambda t: jax.lax.all_to_all(t, "model", split_axis=0, concat_axis=1, tiled=True))

    def body(xl, wl):
        y, vjp = jax.vjp(a2a, xl[0])
        return y[None], vjp(wl[0])[0][None]

    spec = P(("data", "model"))
    jy, jg = shard_map(body, mesh=_jax_mesh(), in_specs=(spec, spec), out_specs=(spec, spec),
                       check_rep=False)(jnp.asarray(x), jnp.asarray(w))
    for r, (y, g) in enumerate(pool.run(task_a2a, x, w, quant)):
        np.testing.assert_allclose(y, np.asarray(jy)[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(jg)[r], rtol=1e-6, atol=1e-6)


def test_expert_parallel_moe_refuses_a_gradient(pool, params):
    """The layer refused a gradient until the sharded model; now it
    differentiates: each rank's gradients are its shard's contribution, an
    expert's slice reaches only the rank holding it, and their sum is the
    unsharded layer's gradient where no shard drops a token."""
    out = pool.run(task_grad, {**CFG, "a2a_quant": False, "capacity_factor": 8.0}, params, _x((4, 8, 16)))
    for k in params:
        np.testing.assert_allclose(sum(g[k] for g, _ in out), out[0][1][k], **TOL)
    for r, (g, _) in enumerate(out):  # rank r = (data r // 2, model r % 2): experts (r % 2), f slice (r // 2)
        assert np.isfinite(g["w_up"]).all()
        held = np.zeros_like(g["w_up"], dtype=bool)
        held[(r % 2) * 4:(r % 2 + 1) * 4, :, (r // 2) * 16:(r // 2 + 1) * 16] = True
        assert not g["w_up"][~held].any() and g["w_up"][held].any()


def test_ef_compress_grads_matches_jax(pool):
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.optim import compress as JC

    rng = np.random.default_rng(6)
    grads = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "b": rng.standard_normal((4, 7)).astype(np.float32)}
    residuals = {k: 1e-3 * rng.standard_normal(v.shape).astype(np.float32) for k, v in grads.items()}
    spec = P(("pod", "data"))

    def body(g, r):
        red, new = JC.ef_compress_grads({k: v[0] for k, v in g.items()}, {k: v[0] for k, v in r.items()}, "pod")
        return {k: v[None] for k, v in red.items()}, {k: v[None] for k, v in new.items()}

    jred, jnew = shard_map(body, mesh=_jax_mesh(("pod", "data")), in_specs=(spec, spec), out_specs=(spec, spec),
                           check_rep=False)({k: jnp.asarray(v) for k, v in grads.items()},
                                            {k: jnp.asarray(v) for k, v in residuals.items()})
    for r, (red, new) in enumerate(pool.run(task_compress, grads, residuals)):
        for k in grads:
            np.testing.assert_allclose(red[k], np.asarray(jred[k])[r], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(new[k], np.asarray(jnew[k])[r], rtol=1e-6, atol=1e-7)


def test_compress_helpers_match_jax_on_one_rank():
    import jax.numpy as jnp

    from repro.optim import compress as JC

    x = _x((6, 9), seed=7) * 3
    q, s = TC.quantize(torch.from_numpy(x))
    jq, js = JC.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    np.testing.assert_allclose(TC.dequantize(q, s).numpy(), np.asarray(JC.dequantize(jq, js)), rtol=1e-7)
    res = TC.init_residuals({"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": [torch.ones(4)]})
    assert res["a"].dtype == torch.float32 and float(res["b"][0].abs().sum()) == 0
    red, new = TC.ef_compress_grads({"a": torch.from_numpy(x)}, {"a": torch.zeros(6, 9)})
    torch.testing.assert_close(red["a"] + new["a"], torch.from_numpy(x), rtol=0, atol=1e-6)


def test_int8_rows_of_the_dispatch_payload_match_jax():
    """The quantizer of the all-to-all's payload: the same int8 rows and
    per-row scales as JAX's ``_qa2a``'s (read off its round trip)."""
    import jax.numpy as jnp

    x = _x((8, 3, 16), seed=8)
    q, scale = TMoE._quantize_rows(torch.from_numpy(x))
    jscale = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True) / 127.0, 1e-12)
    jq = jnp.clip(jnp.round(jnp.asarray(x) / jscale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = TMoE._dequantize_rows(q, scale, torch.float32)
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(scale.max()) / 2 + 1e-7
    assert dataclasses.asdict(TMoE.MoEConfig(**CFG))["a2a_quant"] is True
