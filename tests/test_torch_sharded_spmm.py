"""The sharded planned SpMM of ``repro_torch.parallel.spmm`` on 4 CPU ranks.

One pool of 4 spawned ranks per module (``repro_torch.parallel.rehearsal``:
gloo, a file rendezvous under the test's temporary directory, a 60 s
process-group timeout and a deadline per task), on a ``(data 2, model 2)``
mesh, the power-law operand of JAX's ``tests/test_sharded_spmm.py``
(``BM = BK = BN = 8``, fp32):

* M and N forward, planned and fused (ReLU + bias): bit-equal on every rank
  to the port's unsharded executor, and within rtol = atol = 1e-5 of JAX's
  ``reference`` executor; the pieces of :func:`local_step` put together by
  :func:`assemble` (what the card runs, one rank after another) bit-equal
  to the collective's result;
* K: within 1e-5 of the unsharded result, fused K refused, an indivisible
  shape and an injected shard failure run unsharded (``shard_count`` 1);
* ``Runtime.matmul_sharded``/``matmul_fused_sharded`` gradients on M and N
  bit-equal to the unsharded runtime's;
* M over ``pod`` and ``data`` together (a flattened group of 4);
  ``local_shard``/``gather_shard``; a dynamic-sparsity edit of the plan
  runs sharded bit-equal to unsharded.

The module imports no JAX at its top, so the ranks (which import it to find
their tasks) stay light; the JAX side runs in the test process.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import tensordash_spmm as tspmm
from repro_torch.parallel import spmm
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.parallel.sharding import ShardingPolicy, axis_group, gather_shard, local_shard
from repro_torch.runtime import Runtime, plan_operand
from repro_torch.runtime.backends import KernelRequest, get_backend

BM = BK = BN = 8
MESH = ((2, 2), ("data", "model"))
TOL = dict(rtol=1e-5, atol=1e-5)


def powerlaw_operand(rng, m=512, k=128, *, mean_density=0.5):
    """JAX's ``tests/test_sharded_spmm.py`` operand: power-law block-row
    density around ``mean_density``, densest rows first."""
    a = rng.normal(size=(m, k)).astype(np.float32)
    rb, kb = m // BM, k // BK
    dens = np.clip(rng.pareto(1.2, size=rb) / 3, 1.0 / kb, 1.0)
    dens *= mean_density / dens.mean()
    dens = np.sort(np.clip(dens, 1.0 / kb, 1.0))[::-1]
    for i in range(rb):
        drop = rng.random(kb) > dens[i]
        for j in np.nonzero(drop)[0]:
            a[i * BM:(i + 1) * BM, j * BK:(j + 1) * BK] = 0.0
    return a


def operands():
    rng = np.random.default_rng(5)
    a = powerlaw_operand(rng)
    b = rng.normal(size=(a.shape[1], 64)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    return a, b, bias


def _policy(shape=MESH):
    return ShardingPolicy(mesh=mesh(*shape))


def _request(a, b, bias=None, fused=False):
    plan = plan_operand(a, BM, BK)
    kw = dict(bias=bias, activation="relu") if fused else {}
    return KernelRequest(nnz=plan.nnz, idx=plan.idx, a=a, b=b, bm=BM, bk=BK, bn=BN,
                         workqueue=plan.workqueue(), **kw)


def _np(x):
    return tuple(t.numpy() for t in x) if isinstance(x, tuple) else x.numpy()


# ---------------------------------------------------------------------------
# rank tasks (module level: the ranks import this module to find them)
# ---------------------------------------------------------------------------


def task_forward(axis, fused, balance, mesh_shape=MESH):
    a, b, bias = map(torch.from_numpy, operands())
    req = _request(a, b, bias, fused)
    policy = _policy(mesh_shape)
    be = get_backend("reference")
    want = be.execute_fused(req) if fused else be.execute_planned(req)
    run = spmm.sharded_execute_fused if fused else spmm.sharded_execute_planned
    got = run("reference", req, policy, axis=axis, balance=balance)
    n = spmm.shard_count(req, policy, axis)
    pieces = [spmm.local_step("reference", req, axis, s, n, balance=balance, fused=fused) for s in range(n)]
    order = spmm.shard_order(req, n, balance) if axis == "M" else None
    by_hand = spmm.assemble(axis, pieces, req, order=order, fused=fused)
    return {"got": _np(got), "want": _np(want), "by_hand": _np(by_hand), "shards": n}


def task_refusals():
    a, b, bias = map(torch.from_numpy, operands())
    policy = _policy()
    out = {}
    try:
        spmm.sharded_execute_fused("reference", _request(a, b, bias, True), policy, axis="K")
    except NotImplementedError as e:
        out["fused_k"] = str(e)
    a3 = a[: 3 * BM]
    req3 = _request(a3, b)
    out["indivisible"] = (spmm.shard_count(req3, policy, "M"),
                          torch.equal(spmm.sharded_execute_planned("reference", req3, policy, axis="M"),
                                      get_backend("reference").execute_planned(req3)))
    from repro_torch.resilience import faults
    from repro_torch.resilience.log import ResilienceLog, use_log

    log = ResilienceLog()
    req = _request(a, b)
    with faults.inject(faults.FaultPlan.parse("shard_fail@0")), use_log(log):
        with pytest.warns(RuntimeWarning, match="shard failure"):
            failed = spmm.sharded_execute_planned("reference", req, policy, axis="N")
    out["fault"] = (torch.equal(failed, get_backend("reference").execute_planned(req)),
                    [(e.kind, e.action) for e in log.events])
    return out


def task_grads(axis, fused):
    a, b, bias = map(torch.from_numpy, operands())
    rt = Runtime(backend="reference", device="cpu", bm=BM, bk=BK, bn=BN)
    rts = rt.replace(sharding=_policy())
    grads = []
    for runtime, sharded in ((rt, False), (rts, True)):
        x, w, z = (t.clone().requires_grad_() for t in (a, b, bias))
        if fused:
            run = runtime.matmul_fused_sharded if sharded else runtime.matmul_fused
            out, _ = run(x, w, bias=z, activation="relu", **({"axis": axis} if sharded else {}))
        else:
            out = runtime.matmul_sharded(x, w, axis=axis) if sharded else runtime.matmul(x, w)
        (out ** 2).sum().backward()
        grads.append([t.grad.numpy() for t in ((x, w, z) if fused else (x, w))])
    return grads


def task_edited_plan():
    from repro_torch.sparse_train.plan_edit import PlanDelta, edit_plan

    a, b, _ = map(torch.from_numpy, operands())
    plan = plan_operand(a, BM, BK)
    nnz, idx = plan.nnz.numpy(), plan.idx.numpy()
    dense_r, sparse_r = int(nnz.argmax()), int(nnz.argmin())
    live = (dense_r, int(idx[dense_r, 0]))
    dead = sorted(set(range(idx.shape[1])) - set(idx[sparse_r, : nnz[sparse_r]]))[0]
    edited = edit_plan(plan, PlanDelta.make([live], [(sparse_r, dead)]))
    masked = a.clone()
    r, c = live
    masked[r * BM:(r + 1) * BM, c * BK:(c + 1) * BK] = 0
    req = KernelRequest(nnz=edited.nnz, idx=edited.idx, a=masked, b=b, bm=BM, bk=BK, bn=BN,
                        workqueue=edited.workqueue())
    got = spmm.sharded_execute_planned("reference", req, _policy(), axis="M")
    return torch.equal(got, get_backend("reference").execute_planned(req))


def task_shards_and_groups():
    policy = _policy()
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out = {"rank": torch.distributed.get_rank()}
    for spec in (("data", "model"), ("model", None), (("data", "model"), None), (None, "data")):
        local = local_shard(x, spec, policy)
        out[str(spec)] = (tuple(local.shape), torch.equal(gather_shard(local, spec, policy), x))
    out["axes"] = {ax: policy.spmm_axes(ax)[:2] for ax in "MNK"}
    flat = ShardingPolicy(mesh=mesh((2, 2), ("pod", "data")))
    out["flat"] = flat.spmm_axes("M")[:2], flat.spmm_axes("N")[:2]
    out["flat_index"] = axis_group(flat.mesh, ("pod", "data"))[2]
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's ``reference`` executor on the same operands: planned and fused."""
    import jax.numpy as jnp

    from repro.runtime import plan_operand as jplan_operand
    from repro.runtime.backends import KernelRequest as JRequest
    from repro.runtime.backends import get_backend as jget_backend

    a, b, bias = map(jnp.asarray, operands())
    plan = jplan_operand(a, bm=BM, bk=BK)
    be = jget_backend("reference")
    planned = be.execute_planned(JRequest(nnz=plan.nnz, idx=plan.idx, a=a, b=b, bm=BM, bk=BK, bn=BN,
                                          workqueue=plan.workqueue()))
    fused = be.execute_fused(JRequest(nnz=plan.nnz, idx=plan.idx, a=a, b=b, bias=bias, activation="relu",
                                      bm=BM, bk=BK, bn=BN, workqueue=plan.workqueue()))
    return {False: np.asarray(planned), True: tuple(np.asarray(x) for x in fused)}


@pytest.mark.parametrize("fused", [False, True], ids=["planned", "fused"])
@pytest.mark.parametrize("axis,balance", [("M", True), ("M", False), ("N", True)])
def test_m_and_n_forward_bitwise_on_every_rank(pool, jax_reference, axis, balance, fused):
    results = pool.run(task_forward, axis, fused, balance)
    for res in results:
        assert res["shards"] == 2
        got, want = (res["got"], res["want"]) if fused else ((res["got"],), (res["want"],))
        by_hand = res["by_hand"] if fused else (res["by_hand"],)
        for g, w, h in zip(got, want, by_hand):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(h, g)
    jref = jax_reference[fused] if fused else (jax_reference[fused],)
    np.testing.assert_allclose(got[0], jref[0], **TOL)
    if fused:
        np.testing.assert_array_equal(got[1], jref[1])


def test_k_within_tolerance_and_its_pieces(pool, jax_reference):
    for res in pool.run(task_forward, "K", False, True):
        assert res["shards"] == 2
        np.testing.assert_allclose(res["got"], res["want"], **TOL)
        np.testing.assert_array_equal(res["by_hand"], res["got"])
        np.testing.assert_allclose(res["got"], jax_reference[False], **TOL)


def test_fused_k_refused_indivisible_and_failed_shards_run_unsharded(pool):
    for res in pool.run(task_refusals):
        assert "psum" in res["fused_k"]
        assert res["indivisible"] == (1, True)
        assert res["fault"] == (True, [("shard", "fallback-unsharded")])


@pytest.mark.parametrize("fused", [False, True], ids=["planned", "fused"])
@pytest.mark.parametrize("axis", ["M", "N"])
def test_gradients_bitwise(pool, axis, fused):
    for unsharded, sharded in pool.run(task_grads, axis, fused):
        for want, got in zip(unsharded, sharded):
            np.testing.assert_array_equal(got, want)


def test_m_over_pod_and_data_flattened(pool):
    for res in pool.run(task_forward, "M", False, True, ((2, 2), ("pod", "data"))):
        assert res["shards"] == 4
        np.testing.assert_array_equal(res["got"], res["want"])
        np.testing.assert_array_equal(res["by_hand"], res["got"])


def test_dynamic_refresh_edit_runs_sharded_bitwise(pool):
    assert pool.run(task_edited_plan) == [True] * 4


def test_local_shard_gather_shard_and_axis_groups(pool):
    results = pool.run(task_shards_and_groups)
    for res in results:
        assert res[str(("data", "model"))] == ((4, 3), True)
        assert res[str(("model", None))] == ((4, 6), True)
        assert res[str((("data", "model"), None))] == ((2, 6), True)
        assert res[str((None, "data"))] == ((8, 3), True)
        assert res["axes"] == {"M": (("data",), 2), "N": (("model",), 2), "K": (("model",), 2)}
        assert res["flat"] == ((("pod", "data"), 4), ((), 1))
    assert sorted(r["flat_index"] for r in results) == [0, 1, 2, 3]


def test_meshless_runtime_and_policy_degrade_to_one_device():
    a, b, bias = map(torch.from_numpy, operands())
    rt = Runtime(backend="reference", device="cpu", bm=BM, bk=BK, bn=BN)
    assert rt.mesh is None and rt.replace(sharding=ShardingPolicy()).mesh is None
    assert torch.equal(rt.matmul_sharded(a, b), rt.matmul(a, b))
    out, mask = rt.replace(sharding=ShardingPolicy()).matmul_fused_sharded(a, b, bias=bias, activation="relu")
    want, want_mask = rt.matmul_fused(a, b, bias=bias, activation="relu")
    assert torch.equal(out, want) and torch.equal(mask, want_mask)
    req = _request(a, b)
    assert spmm.shard_count(req, ShardingPolicy(), "M") == 1
    assert torch.equal(spmm.sharded_execute_planned("reference", req, ShardingPolicy()),
                       get_backend("reference").execute_planned(req))


def test_k_partials_of_bf16_operands_are_fp32_in_the_plain_version():
    """The K shard's store on the CPU: bf16 operands, fp32 output, the
    accumulator itself (the kernel's new ``out_type`` 2)."""
    a, b, _ = operands()
    a16, b16 = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    req = _request(a16, b16)
    part = spmm.local_step("reference", req, "K", 0, 2)
    assert part.dtype == torch.float32
    kl = a.shape[1] // 2
    want = spmm.local_request(req, "K", 0, 2)
    acc = tspmm.tensordash_matmul_planned(want.nnz, want.idx, a16[:, :kl], b16[:kl], bm=BM, bk=BK, bn=BN,
                                          out_dtype=torch.float32)
    assert torch.equal(part, acc)
    rounded = tspmm.tensordash_matmul_planned(want.nnz, want.idx, a16[:, :kl], b16[:kl], bm=BM, bk=BK, bn=BN)
    assert torch.equal(rounded, acc.bfloat16())
    assert tspmm._OUT_TYPE[torch.bfloat16, torch.float32] == 2


def test_m_and_n_shards_carry_the_whole_products_split_shape(monkeypatch):
    """An M or N shard's request names the whole product's shape, which the
    cuda backend hands to the wrapper (the kernel then cuts K as the whole
    launch would: bit-equal on the card); a K shard's partial names none."""
    a, b, bias = map(torch.from_numpy, operands())
    req = _request(a, b)
    whole = (a.shape[0], a.shape[1], b.shape[1])
    order = spmm.shard_order(req, 4)
    assert spmm.local_request(req, "M", 1, 4, order=order).split_shape == whole
    assert spmm.local_request(req, "N", 1, 2).split_shape == whole
    assert spmm.local_request(req, "K", 1, 2).split_shape is None
    from repro_torch.runtime import backends

    seen = []
    monkeypatch.setattr(backends.CudaBackend, "_check", lambda self, r: None)
    monkeypatch.setattr(backends, "tensordash_matmul_planned", lambda *x, **kw: seen.append(kw["split_shape"]))
    monkeypatch.setattr(backends, "tensordash_matmul_fused", lambda *x, **kw: seen.append(kw["split_shape"]))
    cuda = get_backend("cuda")
    cuda.execute_planned(spmm.local_request(req, "N", 0, 2))
    cuda.execute_fused(spmm.local_request(_request(a, b, bias, True), "M", 0, 4, order=order))
    cuda.execute_planned(req)
    assert seen == [whole, whole, None]
