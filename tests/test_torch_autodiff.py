"""repro_torch.runtime.autodiff against repro.runtime.autodiff, on the CPU.

* ``transpose_plan(_csr)`` equals the JAX arrays exactly as int32.
* Gradients through ``planned_matmul`` and ``fused_planned_matmul``
  (``relu``, ``squared_relu``, ``none``; with and without bias) under the
  ``reference`` backend equal ``jax.grad`` through the JAX package's
  ``reference`` backend: bit for bit at the kernel tests' shapes (``M, K, N =
  32, 64, 24``, blocks ``4, 8, 8``), and within fp32 rtol = atol = 1e-5
  through ``Runtime.matmul``/``matmul_fused`` at other shapes, where torch's
  ``bmm`` and XLA's dot may sum a block in another order (ROADMAP queue 3);
  the weights there are drawn at N(0, 1/fan_in), as a model's are, so the
  products are O(1) and the tolerance measures reduction order, not the
  cancellation of large terms.
  The bias gradient is a column sum taken in another order: 1e-5 as well.
* The plan cache counts what ``tests/test_backward_planned.py`` counts for
  JAX: 2 entries and 2 misses after one backward; ``2(n-1)`` hits and
  ``n+2`` misses over ``n`` microbatches of ``matmul_grads``.
* The two faults this module repairs: a backend whose outputs are filled
  through a raw pointer (no ``grad_fn``, as the CUDA wrapper's are) still
  passes gradients, through the Functions, and its executor runs twice per
  product in the backward; the CUDA wrapper refuses an operand that
  requires grad outside them; and a weight updated in place misses the
  plan cache and is replanned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.kernels import ref as jref
from repro.kernels import tensordash_spmm as jspmm
from repro.runtime import get_backend as jget_backend
from repro.runtime import plan_operand as jplan_operand
from repro_torch import runtime as trt
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tensordash_spmm as tspmm
from repro_torch.runtime import backends as tbk

BM, BK, BN = 4, 8, 8
M, K, N = 32, 64, 24
GEOM = dict(bm=8, bk=16, bn=16)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _block_sparse(rng, m, k, bm, bk, density):
    a = rng.standard_normal((m, k)).astype(np.float32)
    keep = rng.random((m // bm, k // bk)) < density
    return (a.reshape(m // bm, bm, k // bk, bk) * keep[:, None, :, None]).reshape(m, k)


def _leaf(x):
    return torch.from_numpy(np.array(x)).requires_grad_(True)


# ---------------------------------------------------------------------------
# plan metadata
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("mb,kb", [(8, 8), (5, 11), (1, 7)])
def test_transpose_plan_equals_jax(mb, kb, density):
    rng = np.random.default_rng(mb * 31 + kb)
    mask = (rng.random((mb, kb)) < density).astype(np.int8)
    nnz, idx = jspmm.plan_from_mask(jnp.asarray(mask))
    tnnz, tidx = torch.from_numpy(np.array(nnz)), torch.from_numpy(np.array(idx))
    for j, t in ((jspmm.transpose_plan(nnz, idx), tspmm.transpose_plan(tnnz, tidx)),
                 (jspmm.transpose_plan_csr(nnz, idx), tspmm.transpose_plan_csr(tnnz, tidx))):
        assert len(j) == len(t)
        for x, y in zip(j, t):
            assert y.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # the transpose of the plan is the plan of the transposed mask
    np.testing.assert_array_equal(tspmm.plan_to_mask(*tspmm.transpose_plan(tnnz, tidx)).numpy(),
                                  mask.T != 0)


def test_matmul_grads_ref_equals_jax():
    rng = np.random.default_rng(1)
    a, b, g = (rng.standard_normal(s).astype(np.float32) for s in ((M, K), (K, N), (M, N)))
    for x, y in zip(jref.matmul_grads_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g)),
                    tref.matmul_grads_ref(*(torch.from_numpy(v) for v in (a, b, g)))):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_planned_matmul_grads_equal_jax_bit_for_bit(density):
    """The backend-level product, at the kernel tests' shapes: the same plan,
    the same block schedules, both cotangents equal to ``jax.grad``'s."""
    rng = np.random.default_rng(int(density * 10) + 3)
    a = _block_sparse(rng, M, K, BM, BK, density)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jplan = jplan_operand(jnp.asarray(a), BM, BK)
    jda, jdb = jax.grad(lambda x, y: jnp.sum(
        jget_backend("reference").matmul_planned(jplan, x, y, bn=BN) ** 2), (0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _leaf(a), _leaf(b)
    tplan = trt.plan_operand(ta.detach(), BM, BK)
    out = trt.get_backend("reference").matmul_planned(tplan, ta, tb, bn=BN)
    assert type(out.grad_fn).__name__ == "_PlannedMatmulBackward"
    (out ** 2).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(jda))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jdb))


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("activation", ["none", "relu", "squared_relu"])
def test_fused_planned_matmul_grads_equal_jax(activation, use_bias):
    """The fused product at the kernel tests' shapes: ``da``/``db`` bit for
    bit (the emitted mask plans the ReLU family's cotangent on both
    sides), ``dbias`` (a column sum) within 1e-5."""
    rng = np.random.default_rng(7)
    a = _block_sparse(rng, M, K, BM, BK, 0.5)
    b = rng.standard_normal((K, N)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if use_bias else None
    jplan = jplan_operand(jnp.asarray(a), BM, BK)

    def jloss(x, y, z):
        out, _ = jget_backend("reference").matmul_fused(jplan, x, y, bias=z, activation=activation, bn=BN)
        return jnp.sum(out ** 2)

    jb = None if bias is None else jnp.asarray(bias)
    jgrads = jax.grad(jloss, (0, 1, 2) if use_bias else (0, 1))(jnp.asarray(a), jnp.asarray(b), jb)
    ta, tb = _leaf(a), _leaf(b)
    tbias = None if bias is None else _leaf(bias)
    tplan = trt.plan_operand(ta.detach(), BM, BK)
    out, mask = trt.get_backend("reference").matmul_fused(tplan, ta, tb, bias=tbias,
                                                           activation=activation, bn=BN)
    assert type(out.grad_fn).__name__ == "_FusedMatmulBackward" and not mask.requires_grad
    (out ** 2).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(jgrads[0]))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jgrads[1]))
    if use_bias:
        np.testing.assert_allclose(tbias.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", ["A", "B"])
@pytest.mark.parametrize("m", [32, 29])
def test_runtime_matmul_grads_equal_jax(m, side):
    """Through ``Runtime.matmul`` (side A plans ``a``; side B plans the
    weight under a ``plan_key``), at a shape the runtime's fit clamps."""
    rng = np.random.default_rng(m)
    a = _block_sparse(rng, m, 64, 1, 16, 0.6) if side == "A" else rng.standard_normal((m, 64)).astype(np.float32)
    b = rng.standard_normal((64, 48)).astype(np.float32) / 8  # weights at N(0, 1/fan_in)
    if side == "B":
        b = _block_sparse(rng, 48, 64, 16, 16, 0.5).T.copy() / 8
    jr = jrt.Runtime(backend="reference", **GEOM)
    kw = dict(side="B", plan_key="w") if side == "B" else {}
    jgrads = jax.grad(lambda x, y: jnp.sum(jr.matmul(x, y, **kw) ** 2), (0, 1))(jnp.asarray(a), jnp.asarray(b))
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    ta, tb = _leaf(a), _leaf(b)
    (tr.matmul(ta, tb, **kw) ** 2).sum().backward()
    for t, j in zip((ta.grad, tb.grad), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["none", "relu", "squared_relu"])
def test_runtime_matmul_fused_grads_equal_jax(activation):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((24, 64)).astype(np.float32)
    b = rng.standard_normal((64, 48)).astype(np.float32) / 8
    bias = rng.standard_normal(48).astype(np.float32)
    jr = jrt.Runtime(backend="reference", **GEOM)

    def jloss(x, y, z):
        return jnp.sum(jr.matmul_fused(x, y, bias=z, activation=activation, assume_dense=True)[0] ** 2)

    jgrads = jax.grad(jloss, (0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias))
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    ta, tb, tbias = _leaf(a), _leaf(b), _leaf(bias)
    out, _ = tr.matmul_fused(ta, tb, bias=tbias, activation=activation, assume_dense=True)
    (out ** 2).sum().backward()
    for t, j in zip((ta.grad, tb.grad, tbias.grad), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_relu_with_residual_refuses_to_differentiate_and_none_is_exact():
    rng = np.random.default_rng(9)
    a, b = _leaf(rng.standard_normal((16, 32)).astype(np.float32)), _leaf(rng.standard_normal((32, 16)).astype(np.float32))
    res = _leaf(rng.standard_normal((16, 16)).astype(np.float32))
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    out, _ = tr.matmul_fused(a, b, residual=res, activation="relu", assume_dense=True)
    with pytest.raises(NotImplementedError, match="residual"):
        out.sum().backward()
    out, _ = tr.matmul_fused(a, b, residual=res, activation="none", assume_dense=True)
    (out * 3.0).sum().backward()
    assert torch.equal(res.grad, torch.full((16, 16), 3.0))


# ---------------------------------------------------------------------------
# plan-cache counters (tests/test_backward_planned.py:104 and :128)
# ---------------------------------------------------------------------------


def test_backward_plans_land_in_the_plan_cache():
    rng = np.random.default_rng(2)
    a, b = _leaf(_block_sparse(rng, 32, 64, 16, 32, 0.5)), _leaf(rng.standard_normal((64, 32)).astype(np.float32))
    rt = trt.Runtime(backend="reference", device="cpu", bm=16, bk=32, bn=16)
    (rt.matmul(a, b) ** 2).sum().backward()
    s = rt.plan_cache.stats()
    assert s["entries"] == 2 and s["misses"] == 2, s  # cotangent + lhs-transpose


@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_matmul_grads_reuse_plans_across_microbatches(backend):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(_block_sparse(rng, 32, 64, 16, 32, 0.5))  # static across microbatches
    b = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    rt = trt.Runtime(backend=backend, device="cpu", bm=16, bk=32, bn=16)
    n_mb = 4
    for _ in range(n_mb):
        g = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
        da, db = rt.matmul_grads(a, b, g, plan_key="acts")
        want_da, want_db = tref.matmul_grads_ref(a, b, g)
        torch.testing.assert_close(da, want_da, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(db, want_db, rtol=1e-5, atol=1e-5)
    s = rt.plan_cache.stats()
    # forward plan and its transpose: 1 miss + (n-1) hits each; the
    # cotangent is a fresh tensor every microbatch: n misses
    assert s["hits"] == 2 * (n_mb - 1), s
    assert s["misses"] == n_mb + 2, s


# ---------------------------------------------------------------------------
# the two faults: dropped gradients, stale plans
# ---------------------------------------------------------------------------


class _PointerBackend(tbk.KernelBackend):
    """A sparse backend whose outputs are ``torch.empty`` filled in place,
    as the CUDA wrapper fills its outputs through ``data_ptr()``: they carry
    no ``grad_fn`` of their own."""

    name = "pointer_spy"

    def __init__(self):
        self.planned = self.fused = 0

    def execute_planned(self, req):
        self.planned += 1
        want = tbk._ref_planned(req)
        with torch.no_grad():
            return torch.empty(want.shape, dtype=want.dtype).copy_(want)

    def execute_fused(self, req):
        self.fused += 1
        want, mask = tbk._ref_fused(req)
        with torch.no_grad():
            return torch.empty(want.shape, dtype=want.dtype).copy_(want), mask


@pytest.fixture
def pointer_backend():
    spy = tbk.register_backend(_PointerBackend())
    try:
        yield spy
    finally:
        del tbk._REGISTRY[spy.name]


def test_pointer_filled_outputs_still_pass_gradients(pointer_backend):
    rng = np.random.default_rng(11)
    x = _leaf(rng.standard_normal((16, 32)).astype(np.float32))
    w1 = _leaf((rng.standard_normal((32, 48)) / np.sqrt(32)).astype(np.float32))
    w2 = _leaf((rng.standard_normal((48, 32)) / np.sqrt(48)).astype(np.float32))
    req = tbk.KernelRequest(nnz=torch.full((2,), 2, dtype=torch.int32),
                            idx=torch.arange(2, dtype=torch.int32).expand(2, 2).contiguous(),
                            a=x, b=w2[:32], bm=8, bk=16, bn=16)
    assert pointer_backend.execute_planned(req).grad_fn is None  # what would be dropped
    pointer_backend.planned = 0
    rt = trt.Runtime(backend="pointer_spy", device="cpu", **GEOM)
    h, mask = rt.matmul_fused(x, w1, activation="relu", assume_dense=True)
    y = rt.matmul(h, w2, plan=rt.plan_for_fused_output(mask, h, w2))
    loss = (y ** 2).sum()
    assert (pointer_backend.fused, pointer_backend.planned) == (1, 1)
    loss.backward()
    # each planned product's backward ran both of its products on the backend
    assert (pointer_backend.fused, pointer_backend.planned) == (1, 1 + 2 * 2)
    ref_loss = ((torch.relu(x @ w1) @ w2) ** 2).sum()
    want = torch.autograd.grad(ref_loss, (x, w1, w2))
    for got, exp in zip((x.grad, w1.grad, w2.grad), want):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_cuda_wrapper_refuses_a_grad_requiring_operand():
    """Reached outside the Functions with autograd on, the CUDA wrapper
    raises before any launch (its output would have no ``grad_fn``)."""
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 8)
    nnz, idx, *wq = tspmm.dense_plan_csr(2, 2, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="requires grad"):
        tspmm._launch("planned", nnz, idx, a, b, 4, 8, 8, None, "ragged", tuple(wq))
    with pytest.raises(RuntimeError, match="requires grad"):
        tspmm._launch("fused", nnz, idx, a.detach(), b, 4, 8, 8, None, "ragged", tuple(wq),
                      bias=torch.zeros(8, requires_grad=True))


def test_cuda_wrapper_takes_fp32_operands_with_a_bf16_output_only():
    """The output dtypes the kernel stores: the operands', bf16 from fp32
    operands (the backward's products) and fp32 from bf16 operands (the
    K-sharded product's partials); any other raises before a launch."""
    a, b = torch.randn(8, 16), torch.randn(16, 8)
    nnz, idx, *wq = tspmm.dense_plan_csr(2, 2, torch.device("cpu"))
    with pytest.raises(TypeError, match="as torch.float16"):
        tspmm._launch("planned", nnz, idx, a, b, 4, 8, 8, torch.float16, "ragged", tuple(wq))
    with pytest.raises(TypeError, match="as torch.float16"):
        tspmm._launch("planned", nnz, idx, a.bfloat16(), b.bfloat16(), 4, 8, 8, torch.float16,
                      "ragged", tuple(wq))
    assert tspmm._OUT_TYPE == {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 0,
                               (torch.float32, torch.bfloat16): 1, (torch.bfloat16, torch.float32): 2}


def test_plan_cache_replans_a_weight_updated_in_place():
    """A weight with planted zero blocks, updated in place so that other
    blocks are zero: the cached plan must not be replayed (it would skip
    blocks that now hold values and compute blocks that are zero)."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(_block_sparse(rng, 64, 48, 16, 16, 0.5))  # [K, N], planned side B
    h = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    rt = trt.Runtime(backend="reference", device="cpu", **GEOM)
    key = ("lm_head", id(w))
    y0 = rt.matmul(h, w, plan_key=key, side="B")
    y1 = rt.matmul(h, w, plan_key=key, side="B")
    assert rt.plan_cache.stats() == {"entries": 1, "hits": 1, "misses": 1}
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    stale = rt.plan_cache.lookup(key, w, 16, 16, side="B")
    new = torch.from_numpy(_block_sparse(np.random.default_rng(13), 64, 48, 16, 16, 0.5))
    with torch.no_grad():
        w.copy_(new)  # other blocks zero now: same tensor object, new version
    assert not torch.equal(tspmm.plan_to_mask(stale.nnz, stale.idx),
                           tspmm.plan_to_mask(*tspmm.plan_blocks(w.T, 16, 16)))
    assert rt.plan_cache.lookup(key, w, 16, 16, side="B") is None
    y2 = rt.matmul(h, w, plan_key=key, side="B")
    s = rt.plan_cache.stats()
    assert (s["entries"], s["hits"], s["misses"]) == (1, 2, 2), s  # replaced under the same key
    torch.testing.assert_close(y2, h @ w, rtol=1e-5, atol=1e-5)
    replanned = rt.plan_cache.lookup(key, w, 16, 16, side="B")
    assert torch.equal(tspmm.plan_to_mask(replanned.nnz, replanned.idx),
                       tspmm.plan_to_mask(*tspmm.plan_blocks(w.T, 16, 16)))
