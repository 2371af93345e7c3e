"""repro_torch.runtime against repro.runtime on the CPU.

The same numpy operands go through ``Runtime.matmul`` (side A, side B with
``plan_key``), ``matmul_fused`` and ``plan_for_fused_output`` in both
packages at fitted odd geometries, under the ``reference`` and ``dense``
backends.  Plans and masks are compared exactly (int32 / int8).  Outputs
are fp32 and agree within rtol = atol = 1e-5: both executors walk the same
block schedule, but at some shapes (a 3-column side-B product) torch's CPU
``bmm`` sums a block's products in another order than XLA's dot, which
moves the last bits.  The plan cache counts the same hits and misses for
the same eager call sequence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro_torch import runtime as trt
from repro_torch.runtime import BackendCapabilityError, get_backend

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


def _pair(backend):
    return (jrt.Runtime(backend=backend, **GEOM),
            trt.Runtime(backend=backend, device="cpu", **GEOM))


def _same(j, t):
    """Exact for plan metadata and masks, fp32 tolerance for values."""
    j, t = np.asarray(j), t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("m", [3, 24])
def test_matmul_side_a_matches_jax(m, backend):
    rng = np.random.default_rng(m)
    a = _block_sparse(rng, m, 64, 1, 16, 0.5)
    b = rng.standard_normal((64, 40)).astype(np.float32)
    jr, tr = _pair(backend)
    _same(jr.matmul(jnp.asarray(a), jnp.asarray(b)),
          tr.matmul(torch.from_numpy(a), torch.from_numpy(b)))
    assert tr.fit((m, 64), (64, 40)) == tr.replace(**{
        k: getattr(jr.fit((m, 64), (64, 40)), k) for k in ("bm", "bk", "bn")})


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("m", [3, 24])
def test_matmul_side_b_plan_key_matches_jax_and_counts(m, backend):
    rng = np.random.default_rng(10 + m)
    w = _block_sparse(rng, 64, 48, 16, 16, 0.5)  # weight with zero blocks
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jr, tr = _pair(backend)
    for step in range(3):
        x = rng.standard_normal((m, 64)).astype(np.float32)
        _same(jr.matmul(jnp.asarray(x), jw, plan_key=("w", 0), side="B"),
              tr.matmul(torch.from_numpy(x), tw, plan_key=("w", 0), side="B"))
        js, ts = jr.plan_cache.stats(), tr.plan_cache.stats()
        assert (ts["hits"], ts["misses"]) == (js["hits"], js["misses"]) == (step, 1)
    # a rebound weight under the same key misses, in both packages
    tw2 = tw.clone()
    jw2 = jnp.array(w)
    x = rng.standard_normal((m, 64)).astype(np.float32)
    _same(jr.matmul(jnp.asarray(x), jw2, plan_key=("w", 0), side="B"),
          tr.matmul(torch.from_numpy(x), tw2, plan_key=("w", 0), side="B"))
    js, ts = jr.plan_cache.stats(), tr.plan_cache.stats()
    assert (ts["hits"], ts["misses"]) == (js["hits"], js["misses"]) == (2, 2)


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("activation", ["relu", "squared_relu", "none"])
@pytest.mark.parametrize("m", [3, 24])
def test_matmul_fused_and_emitted_plan_match_jax(m, activation, backend):
    rng = np.random.default_rng(20 + m)
    x = rng.standard_normal((m, 32)).astype(np.float32)
    w1 = rng.standard_normal((32, 96)).astype(np.float32)
    w2 = rng.standard_normal((96, 40)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32) - 1.0  # push ReLU to zero blocks
    jr, tr = _pair(backend)
    jh, jmask = jr.matmul_fused(jnp.asarray(x), jnp.asarray(w1), bias=jnp.asarray(bias),
                                activation=activation, assume_dense=True)
    th, tmask = tr.matmul_fused(torch.from_numpy(x), torch.from_numpy(w1),
                                bias=torch.from_numpy(bias), activation=activation,
                                assume_dense=True)
    _same(jh, th)
    _same(jmask, tmask)
    jplan = jr.plan_for_fused_output(jmask, jh, jnp.asarray(w2))
    tplan = tr.plan_for_fused_output(tmask, th, torch.from_numpy(w2))
    assert (tplan.bm, tplan.bk, tplan.shape) == (jplan.bm, jplan.bk, jplan.shape)
    for name in ("nnz", "idx", "row_starts", "work_row", "work_kblk"):
        _same(getattr(jplan, name), getattr(tplan, name))
    _same(jr.matmul(jh, jnp.asarray(w2), plan=jplan),
          tr.matmul(th, torch.from_numpy(w2), plan=tplan))


def test_cuda_backend_refuses_without_a_card():
    rt = trt.Runtime(backend="cuda", device="cpu", **GEOM)
    a, b = torch.ones(8, 16), torch.ones(16, 16)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal is for machines without one")
    with pytest.raises(BackendCapabilityError):
        rt.kernel.check_platform()
    with pytest.raises(BackendCapabilityError):
        rt.matmul(a, b)
    with pytest.raises(BackendCapabilityError):
        rt.matmul_fused(a, b, activation="relu", assume_dense=True)
    with pytest.raises(BackendCapabilityError):
        rt.matmul(a, b, plan_key=("w", 0), side="B")


@pytest.mark.parametrize("grid", ["v2", "v1", True, False])
def test_cuda_backend_refuses_unported_grid_families(grid):
    with pytest.raises(BackendCapabilityError, match="ROADMAP"):
        get_backend("cuda").check_grid(grid)
    get_backend("cuda").check_grid("ragged")


def test_runtime_policy_checks():
    with pytest.raises(ValueError):
        trt.Runtime(compact_grid="v3")
    with pytest.raises(ValueError):
        trt.Runtime(backend="pallas")  # not registered in the port
    rt = trt.Runtime(backend="reference", device="cpu", accum_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        rt.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert trt.resolve() is trt.default_runtime()
    assert trt.default_runtime().backend == "cuda" and trt.default_runtime().device.type == "cuda"
    with rt.use():
        assert trt.resolve() is rt and trt.current() is rt
    assert trt.current() is None
