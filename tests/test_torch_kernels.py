"""repro_torch kernels module against the JAX package, on the CPU.

* Planning metadata (``plan_blocks_csr``, ``plan_from_mask_csr`` with
  coarsen 1 and 2, ``dense_plan_csr``, ``plan_workqueue``) equals the JAX
  arrays exactly as int32, over the row distributions of ``test_spmm_v3``.
* The plain executors equal ``repro.kernels.ref`` bit for bit in fp32.  In
  bf16 the outputs agree within one bf16 rounding step (rtol 2**-7): both
  sides sum the same fp32 products, but XLA's dot and torch's bmm may sum
  a block in another order, and a last-bit fp32 difference can flip the
  bf16 rounding.  The emitted masks are equal exactly in both dtypes.
* One exception, a fault of the reference on this JAX: for squared_relu
  plus a residual, XLA contracts the square and the add into one FMA
  although ``repro.kernels.ref._epilogue_ref`` pins two roundings.  The port
  rounds twice (as the CUDA kernel does, with ``__fmul_rn``/``__fadd_rn``):
  it equals numpy's two-rounding epilogue of the JAX accumulator bit for
  bit, and the JAX output within one ulp of the square plus one ulp of the
  sum (the rounding the FMA skips).
* Wrappers given CPU tensors run the plain versions and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import tensordash_spmm as jspmm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tensordash_spmm as tspmm
from test_spmm_v3 import DISTRIBUTIONS, _operand_with_row_nnz

BM, BK, BN = 4, 8, 8
M, K, N = 32, 64, 24


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operand(dist, seed=0):
    rng = np.random.default_rng(seed)
    row_nnz = DISTRIBUTIONS[dist](K // BK, M // BM, rng)
    return _operand_with_row_nnz(rng, M, K, BM, BK, row_nnz)


def _t(x):
    """A JAX/numpy array as a (writable) torch tensor."""
    return torch.from_numpy(np.array(x))


def _eq(j_arrays, t_tensors):
    assert len(j_arrays) == len(t_tensors)
    for j, t in zip(j_arrays, t_tensors):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
@pytest.mark.parametrize("what", ["blocks_csr", "mask_c1", "mask_c2", "workqueue"])
def test_plan_metadata_equals_jax(dist, what):
    a = _operand(dist)
    if what == "blocks_csr":
        _eq(jspmm.plan_blocks_csr(jnp.asarray(a), BM, BK),
            tspmm.plan_blocks_csr(torch.from_numpy(a), BM, BK))
    elif what.startswith("mask"):
        coarsen = int(what[-1])
        mb, kb = M // BM, K // BK
        mask = (a.reshape(mb, BM, kb, BK) != 0).any(axis=(1, 3)).astype(np.int8)
        _eq(jspmm.plan_from_mask_csr(jnp.asarray(mask), coarsen=coarsen),
            tspmm.plan_from_mask_csr(torch.from_numpy(mask), coarsen=coarsen))
    else:
        nnz, idx = jspmm.plan_blocks(jnp.asarray(a), BM, BK)
        _eq(jspmm.plan_workqueue(nnz, idx),
            tspmm.plan_workqueue(_t(nnz), _t(idx)))


@pytest.mark.parametrize("mb,kb", [(1, 1), (3, 5), (8, 2)])
def test_dense_plan_csr_equals_jax(mb, kb):
    _eq(jspmm.dense_plan_csr(mb, kb), tspmm.dense_plan_csr(mb, kb, torch.device("cpu")))


def test_plan_to_mask_roundtrip():
    a = _operand("mixed", seed=3)
    nnz, idx = tspmm.plan_blocks(torch.from_numpy(a), BM, BK)
    j_nnz, j_idx = jspmm.plan_blocks(jnp.asarray(a), BM, BK)
    np.testing.assert_array_equal(np.asarray(jspmm.plan_to_mask(j_nnz, j_idx)),
                                  tspmm.plan_to_mask(nnz, idx).numpy())


def _inputs(dist, dtype, seed=0):
    rng = np.random.default_rng(seed + 100)
    a = _operand(dist, seed)
    b = rng.standard_normal((K, N)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = [jnp.asarray(x, jdt) for x in (a, b, res)] + [jnp.asarray(bias)]
    t = [torch.from_numpy(x).to(dtype) for x in (a, b, res)] + [torch.from_numpy(bias)]
    return j, t


def _assert_close(j_out, t_out, dtype):
    j = np.asarray(j_out.astype(jnp.float32))
    t = t_out.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_array_equal(j, t)  # bit for bit
    else:
        np.testing.assert_allclose(t, j, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_planned_executor_equals_jax(dist, dtype):
    (ja, jb, _, _), (ta, tb, _, _) = _inputs(dist, dtype)
    nnz, idx = jspmm.plan_blocks(ja, BM, BK)
    j_out = jref.tensordash_matmul_ref(nnz, idx, ja, jb, bm=BM, bk=BK, bn=BN)
    t_out = tref.tensordash_matmul_ref(_t(nnz), _t(idx), ta, tb, bm=BM, bk=BK, bn=BN)
    assert t_out.dtype == dtype
    _assert_close(j_out, t_out, dtype)


#: (activation, bias, residual): every activation bare and with both
#: extras, plus each extra alone where it meets the activation's edge cases
EPILOGUES = [
    ("none", False, False), ("relu", False, False), ("squared_relu", False, False),
    ("none", True, True), ("relu", True, True), ("squared_relu", True, True),
    ("relu", True, False), ("squared_relu", False, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,use_bias,use_res", EPILOGUES)
@pytest.mark.parametrize("dist", ["all_zero", "mixed"])
def test_fused_executor_equals_jax(dist, activation, use_bias, use_res, dtype):
    (ja, jb, jres, jbias), (ta, tb, tres, tbias) = _inputs(dist, dtype, seed=1)
    nnz, idx = jspmm.plan_blocks(ja, BM, BK)
    j_out, j_mask = jref.tensordash_matmul_fused_ref(
        nnz, idx, ja, jb, jbias if use_bias else None, jres if use_res else None,
        bm=BM, bk=BK, bn=BN, activation=activation)
    t_out, t_mask = tref.tensordash_matmul_fused_ref(
        _t(nnz), _t(idx), ta, tb, tbias if use_bias else None, tres if use_res else None,
        bm=BM, bk=BK, bn=BN, activation=activation)
    if dtype == torch.float32 and activation == "squared_relu" and use_res:
        j_acc, _ = jref.tensordash_matmul_fused_ref(
            nnz, idx, ja, jb, jbias if use_bias else None, None,
            bm=BM, bk=BK, bn=BN, activation="squared_relu")
        two_roundings = np.asarray(j_acc) + np.asarray(jres)  # fp32 add of the rounded square
        np.testing.assert_array_equal(t_out.numpy(), two_roundings)
        # FMA skips the square's rounding: at most 1 ulp of the square plus
        # 1 ulp of the sum apart (several ulps of the sum near cancellation)
        sq, j = np.asarray(j_acc), np.asarray(j_out)
        assert np.all(np.abs(t_out.numpy() - j) <= np.spacing(np.abs(sq)) + np.spacing(np.abs(j)))
    else:
        _assert_close(j_out, t_out, dtype)
    assert t_mask.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(j_mask), t_mask.numpy())


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    tspmm.reset_launch_counts()
    _, (ta, tb, tres, tbias) = _inputs("mixed", torch.float32, seed=2)
    nnz, idx, *wq = tspmm.plan_blocks_csr(ta, BM, BK)
    out = tspmm.tensordash_matmul_planned(nnz, idx, ta, tb, bm=BM, bk=BK, bn=BN, workqueue=wq)
    torch.testing.assert_close(out, tref.tensordash_matmul_ref(nnz, idx, ta, tb, bm=BM, bk=BK, bn=BN),
                               rtol=0, atol=0)
    fo, fm = tspmm.tensordash_matmul_fused(nnz, idx, ta, tb, tbias, tres, activation="relu",
                                           bm=BM, bk=BK, bn=BN)
    ro, rm = tref.tensordash_matmul_fused_ref(nnz, idx, ta, tb, tbias, tres, bm=BM, bk=BK,
                                              bn=BN, activation="relu")
    torch.testing.assert_close(fo, ro, rtol=0, atol=0)
    assert torch.equal(fm, rm)
    assert tspmm.launch_counts() == {"tensordash_matmul_planned": 0, "tensordash_matmul_fused": 0}


def test_kernel_tile_fits_main_path_geometries():
    """The CUDA tiling chosen for the main path's decode and prefill
    geometries: TN divides bn, bm * TN fits the CTA, KC fits 48 KB."""
    for bm, bk, bn in [(4, 512, 128), (4, 128, 128), (128, 512, 4), (48, 512, 128), (128, 512, 48)]:
        tn, kc = tspmm.kernel_tile(bm, bk, bn)
        assert bn % tn == 0 and bm * tn <= 2048 and 1 <= kc <= bk
        assert 4 * (bm * (kc + 1) + kc * (tn + 1)) <= 48 * 1024


def test_kernel_splits_fill_the_card_without_reading_nnz():
    # decode w_down: 128 column tiles x 1 block row on 132 SMs -> 5 shares
    assert tspmm.kernel_splits(128, 86, 132) == 5
    assert tspmm.kernel_splits(344, 8, 132) == 2  # decode gate
    assert tspmm.kernel_splits(800, 8, 132) == 1  # LM head: enough tiles already
    assert tspmm.kernel_splits(1, 3, 132) == 3  # never more shares than K blocks


def test_vector_loads_only_when_aligned():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    assert tspmm._vec_ok(x, x.stride(0), 32, 64) == 1
    assert tspmm._vec_ok(x, x.stride(0), 12) == 0  # a tile extent off the 8-element grid
    assert tspmm._vec_ok(x[:, 1:], x.stride(0), 32) == 0  # base pointer off 16 bytes
    y = torch.zeros(8, 6, dtype=torch.float32)
    assert tspmm._vec_ok(y, y.stride(0), 4) == 0  # row stride of 6 floats
