"""``repro_torch.kernels.ops`` and ``Runtime.sparse_ffn`` against JAX's
``repro.kernels.ops`` on the CPU.

The same seeded numpy operands go through each public wrapper of both
packages on the ``reference`` and ``dense`` backends (the port's plain
executors; JAX's reference executor and XLA): ``matmul``,
``matmul_fused`` (output and emitted mask), ``matmul_grads`` and
``sparse_ffn`` for both activations, on the fused path, on the unfused
chain a measured ``ffn`` policy with ``fuse=False`` selects, and on the
dense backend's two plain products; the ``bm``/``bk``/``bn`` overrides
reach the plan.  fp32 outputs agree within rtol = atol = 1e-5 (both walk
the same block schedule, but torch's CPU products sum a block in another
order than XLA's dot); masks are exact.  ``tensordash_matmul`` (plan, then
execute) and ``sparse_ffn_ref`` are held to JAX's too, and
``supports_matmul`` says no for ``cuda`` off the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tensordash_spmm as jspmm
from repro.tune.db import TunedPolicy as JPolicy
from repro.tune.db import TuningDB as JDB
from repro_torch import runtime as trt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tensordash_spmm as tspmm
from repro_torch.tune.db import TunedPolicy as TPolicy
from repro_torch.tune.db import TuningDB as TDB

GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _pair(backend, **kw):
    return (jrt.Runtime(backend=backend, **GEOM, **kw),
            trt.Runtime(backend=backend, device="cpu", **GEOM, **kw))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_the_public_names_are_jax_s():
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name))


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("override", [{}, {"bm": 4, "bk": 8}])
def test_matmul_equals_jax(backend, override):
    rng = np.random.default_rng(1)
    a = _block_sparse(rng, 24, 64, 4, 8, 0.5)
    b = rng.standard_normal((64, 40)).astype(np.float32)
    jr, tr = _pair(backend)
    _close(tops.matmul(torch.from_numpy(a), torch.from_numpy(b), runtime=tr, **override),
           jops.matmul(jnp.asarray(a), jnp.asarray(b), runtime=jr, **override))
    with tr.use():  # the ambient runtime
        _close(tops.matmul(torch.from_numpy(a), torch.from_numpy(b), **override), a @ b)


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("activation", ["none", "relu", "squared_relu"])
def test_matmul_fused_equals_jax(backend, activation):
    rng = np.random.default_rng(2)
    a = _block_sparse(rng, 16, 64, 8, 16, 0.6)
    b = rng.standard_normal((64, 48)).astype(np.float32)
    bias = rng.standard_normal((48,)).astype(np.float32)
    res = rng.standard_normal((16, 48)).astype(np.float32)
    jr, tr = _pair(backend)
    j_out, j_mask = jops.matmul_fused(jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                                      residual=jnp.asarray(res), activation=activation, runtime=jr)
    t_out, t_mask = tops.matmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                                      bias=torch.from_numpy(bias), residual=torch.from_numpy(res),
                                      activation=activation, runtime=tr)
    _close(t_out, j_out)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("backend", ["reference", "dense"])
def test_matmul_grads_equals_jax(backend):
    rng = np.random.default_rng(3)
    a = _block_sparse(rng, 16, 32, 8, 16, 0.5)
    b = rng.standard_normal((32, 48)).astype(np.float32)
    g = _block_sparse(rng, 16, 48, 8, 16, 0.5)
    jr, tr = _pair(backend)
    jda, jdb = jops.matmul_grads(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), runtime=jr)
    tda, tdb = tops.matmul_grads(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(g),
                                 runtime=tr)
    _close(tda, jda)
    _close(tdb, jdb)


def _ffn_operands(seed, lead=(3, 8)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, 32)).astype(np.float32)
    w1 = rng.standard_normal((32, 64)).astype(np.float32) / 4
    w2 = rng.standard_normal((64, 32)).astype(np.float32) / 8
    return x, w1, w2


@pytest.mark.parametrize("backend", ["reference", "dense"])
@pytest.mark.parametrize("activation", ["relu", "squared_relu"])
def test_sparse_ffn_equals_jax(backend, activation):
    x, w1, w2 = _ffn_operands(4)
    jr, tr = _pair(backend)
    t = tops.sparse_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                        activation=activation, runtime=tr)
    assert t.shape == x.shape
    _close(t, jops.sparse_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                              activation=activation, runtime=jr))
    _close(t, jref.sparse_ffn_ref(jnp.asarray(x.reshape(-1, 32)), jnp.asarray(w1), jnp.asarray(w2),
                                  activation).reshape(x.shape))


@pytest.mark.parametrize("activation", ["relu", "squared_relu"])
def test_sparse_ffn_ref_equals_jax(activation):
    x, w1, w2 = _ffn_operands(5, lead=(24,))
    _close(tref.sparse_ffn_ref(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                               activation),
           jref.sparse_ffn_ref(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), activation))
    with pytest.raises(ValueError):
        tref.sparse_ffn_ref(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), "gelu")


def test_sparse_ffn_refuses_other_activations():
    x, w1, w2 = _ffn_operands(6)
    for backend in ("reference", "dense"):
        with pytest.raises(ValueError):
            tops.sparse_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                            activation="silu", runtime=trt.Runtime(backend=backend, device="cpu"))


def test_sparse_ffn_fused_path_plans_w2_from_the_emitted_mask(monkeypatch):
    """On a sparse backend the second product's plan comes from the first
    one's emitted mask: no plan of the intermediate by value."""
    from repro_torch.runtime import runtime as rtmod

    built = []
    real = rtmod.plan_operand
    monkeypatch.setattr(rtmod, "plan_operand", lambda *a, **k: (built.append(a[0].shape), real(*a, **k))[1])
    x, w1, w2 = _ffn_operands(7, lead=(16,))
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    tops.sparse_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), runtime=tr)
    assert built == []


def _ffn_dbs(m, k, n, fuse):
    pol = dict(bm=8, bk=16, bn=16, fuse=fuse, backend="reference")
    jdb, tdb = JDB(platform="cpu"), TDB(platform="cpu")
    jdb.store(jdb.key(op="ffn", m=m, k=k, n=n, dtype=np.float32), JPolicy(**pol))
    tdb.store(tdb.key(op="ffn", m=m, k=k, n=n, dtype=torch.float32), TPolicy(**pol))
    return jdb, tdb


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("activation", ["relu", "squared_relu"])
def test_sparse_ffn_under_a_tuned_ffn_policy_equals_jax(fuse, activation, monkeypatch):
    x, w1, w2 = _ffn_operands(8, lead=(16,))
    jdb, tdb = _ffn_dbs(16, 32, 64, fuse)
    jr = jrt.Runtime(backend="reference", geometry="auto", tuning_db=jdb, **GEOM)
    tr = trt.Runtime(backend="reference", device="cpu", geometry="auto", tuning_db=tdb, **GEOM)
    fused = []
    real = trt.Runtime.matmul_fused
    monkeypatch.setattr(trt.Runtime, "matmul_fused",
                        lambda self, *a, **k: (fused.append(1), real(self, *a, **k))[1])
    t = tops.sparse_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                        activation=activation, runtime=tr)
    assert bool(fused) == fuse  # fuse=False: the unfused chain
    _close(t, jops.sparse_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                              activation=activation, runtime=jr))


@pytest.mark.parametrize("grid", ["ragged", "v2", "v1"])
def test_tensordash_matmul_plans_then_executes_like_jax(grid):
    """JAX's ``tensordash_matmul`` is ``plan_blocks`` then the Pallas
    kernel, whose plain executor is ``tensordash_matmul_ref``."""
    rng = np.random.default_rng(9)
    a = _block_sparse(rng, 32, 64, 8, 16, 0.4)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    t = tspmm.tensordash_matmul(torch.from_numpy(a), torch.from_numpy(b), bm=8, bk=16, bn=16,
                                compact_grid=grid)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(t, jref.tensordash_matmul_ref(*jspmm.plan_blocks(ja, 8, 16), ja, jb, bm=8, bk=16, bn=16))


def test_supports_matmul():
    assert trt.Runtime(backend="reference", device="cpu").supports_matmul((8, 8), (8, 8))
    assert trt.Runtime(backend="dense", device="cpu").supports_matmul((8, 8), (8, 8), side="B")
    on_card = torch.cuda.is_available() and torch.cuda.get_device_capability()[0] == 9
    assert trt.Runtime(backend="cuda", device="cpu").supports_matmul((8, 8), (8, 8)) == on_card
    assert trt.Runtime(backend="cuda").supports_matmul((128, 512), (512, 128)) == on_card
    assert jrt.Runtime(backend="reference").supports_matmul((8, 8), (8, 8))
