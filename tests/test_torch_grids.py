"""The v1/v2 grid families and the static plan/grid checks of repro_torch
against the JAX package, on the CPU.

* The port's CPU wrappers run every grid family through the plain
  executors.  For ``compact_grid`` ``"v2"``/``"v1"`` they equal the JAX
  ``reference`` backend bit for bit in fp32; squared_relu with a residual is
  the one exception, a fault of the reference on this JAX (ROADMAP queue 3:
  XLA contracts the square and the add into one FMA), held to one ulp of
  the square plus one ulp of the sum as in ``test_torch_kernels``.
* The same outputs agree with the Pallas kernels of the JAX package run in
  interpret mode at the same ``compact_grid`` within rtol = atol = 2e-4,
  the JAX suite's bound for planned products against dense math
  (interpret mode has drifted from ``reference`` on this JAX).
* ``planned_grid_steps`` and ``SparsityPlan.grid_steps`` give the JAX
  counts per family.
* ``check_grid`` (which models the CUDA kernels' ``(N/TN, Mb, S)`` grid) and
  ``verify_plan`` give the JAX package's finding codes on clean plans and on
  the same corrupted ones, for any split count ``S`` and for every ``S``
  the launch's split rule (``kernel_splits``) produces.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import check_grid as jcheck_grid
from repro.analysis import verify_plan as jverify_plan
from repro.kernels import tensordash_spmm as jspmm
from repro.runtime import plan as jplan_mod
from repro.runtime.backends import KernelRequest as JRequest
from repro.runtime.backends import get_backend as jget_backend
from repro_torch.analysis import check_grid, check_plan_grid, verify_plan
from repro_torch.kernels import tensordash_spmm as tspmm
from repro_torch.runtime import plan as tplan_mod
from test_spmm_v3 import DISTRIBUTIONS, _operand_with_row_nnz

BM, BK, BN = 4, 8, 8
M, K, N = 32, 64, 24
GRIDS = ("v2", "v1")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(dist, seed=0):
    rng = np.random.default_rng(seed)
    a = _operand_with_row_nnz(rng, M, K, BM, BK, DISTRIBUTIONS[dist](K // BK, M // BM, rng))
    b = rng.standard_normal((K, N)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return a, b, bias, res


def _plans(a):
    nnz, idx = jspmm.plan_blocks(jnp.asarray(a), BM, BK)
    return (nnz, idx), tuple(torch.from_numpy(np.array(x)) for x in (nnz, idx))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_grid_planned_equals_jax_reference_backend(dist, grid):
    a, b, _, _ = _inputs(dist)
    (jn, ji), (tn, ti) = _plans(a)
    j_out = jget_backend("reference").execute_planned(JRequest(
        nnz=jn, idx=ji, a=jnp.asarray(a), b=jnp.asarray(b), bm=BM, bk=BK, bn=BN, compact_grid=grid))
    t_out = tspmm.tensordash_matmul_planned(tn, ti, torch.from_numpy(a), torch.from_numpy(b),
                                            bm=BM, bk=BK, bn=BN, compact_grid=grid)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))  # bit for bit


EPILOGUES = [("relu", True, False), ("none", True, True), ("relu", True, True),
             ("squared_relu", False, False), ("squared_relu", True, True)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("activation,use_bias,use_res", EPILOGUES)
@pytest.mark.parametrize("dist", ["all_zero", "mixed", "skewed"])
def test_grid_fused_equals_jax_reference_backend(dist, activation, use_bias, use_res, grid):
    a, b, bias, res = _inputs(dist, seed=1)
    (jn, ji), (tn, ti) = _plans(a)
    jbias, jres = (jnp.asarray(bias) if use_bias else None), (jnp.asarray(res) if use_res else None)
    tbias = torch.from_numpy(bias) if use_bias else None
    tres = torch.from_numpy(res) if use_res else None
    j_out, j_mask = jget_backend("reference").execute_fused(JRequest(
        nnz=jn, idx=ji, a=jnp.asarray(a), b=jnp.asarray(b), bias=jbias, residual=jres,
        activation=activation, bm=BM, bk=BK, bn=BN, compact_grid=grid))
    t_out, t_mask = tspmm.tensordash_matmul_fused(
        tn, ti, torch.from_numpy(a), torch.from_numpy(b), tbias, tres, activation=activation,
        bm=BM, bk=BK, bn=BN, compact_grid=grid)
    j, t = np.asarray(j_out), t_out.numpy()
    if activation == "squared_relu" and use_res:
        sq = np.asarray(jget_backend("reference").execute_fused(JRequest(
            nnz=jn, idx=ji, a=jnp.asarray(a), b=jnp.asarray(b), bias=jbias, activation=activation,
            bm=BM, bk=BK, bn=BN, compact_grid=grid))[0])
        np.testing.assert_array_equal(t, sq + res)  # two roundings, as the CUDA kernel
        assert np.all(np.abs(t - j) <= np.spacing(np.abs(sq)) + np.spacing(np.abs(j)))
    else:
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dist", ["mixed", "skewed"])
def test_grid_families_agree_with_jax_interpret_kernels(dist, grid):
    a, b, bias, res = _inputs(dist, seed=2)
    (jn, ji), (tn, ti) = _plans(a)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    j_out = jspmm.tensordash_matmul_planned(jn, ji, ja, jb, bm=BM, bk=BK, bn=BN,
                                            compact_grid=grid, interpret=True)
    t_out = tspmm.tensordash_matmul_planned(tn, ti, ta, tb, bm=BM, bk=BK, bn=BN, compact_grid=grid)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-4, atol=2e-4)
    jf, jm = jspmm.tensordash_matmul_fused(jn, ji, ja, jb, jnp.asarray(bias), jnp.asarray(res),
                                           activation="relu", bm=BM, bk=BK, bn=BN,
                                           compact_grid=grid, interpret=True)
    tf, tm = tspmm.tensordash_matmul_fused(tn, ti, ta, tb, torch.from_numpy(bias),
                                           torch.from_numpy(res), activation="relu",
                                           bm=BM, bk=BK, bn=BN, compact_grid=grid)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("grid", ["ragged", *GRIDS])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_grid_steps_equal_jax(dist, grid):
    a, _, _, _ = _inputs(dist, seed=3)
    (jn, _), (tn, _) = _plans(a)
    mb, kb, nb = M // BM, K // BK, N // BN
    want = jspmm.planned_grid_steps(jn, kb, mb, nb, compact_grid=grid)
    assert tspmm.planned_grid_steps(tn, kb, mb, nb, compact_grid=grid) == want
    jp = jplan_mod.plan_operand(jnp.asarray(a), BM, BK)
    tp = tplan_mod.plan_operand(torch.from_numpy(a), BM, BK)
    assert tp.grid_steps(nb, compact_grid=grid) == jp.grid_steps(nb, compact_grid=grid) == want
    assert tp.max_nnz() == jp.max_nnz()


# ---------------------------------------------------------------------------
# static checks: the same finding codes on the same corrupted plans
# ---------------------------------------------------------------------------


def _codes(findings):
    return sorted({f.code for f in findings})


def _plan_pair(seed=0, density=0.35, rb=12, kb=16, bm=8, bk=8):
    rng = np.random.default_rng(seed)
    keep = rng.random((rb, kb)) < density
    keep[3] = False  # an all-zero row
    a = rng.standard_normal((rb * bm, kb * bk)).astype(np.float32)
    a = (a.reshape(rb, bm, kb, bk) * keep[:, None, :, None]).reshape(rb * bm, kb * bk)
    return jplan_mod.plan_operand(jnp.asarray(a), bm, bk), tplan_mod.plan_operand(torch.from_numpy(a), bm, bk)


def _replace_both(jp, tp, **fields):
    """Both plans with the same numpy values put in place of ``fields``."""
    return (dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in fields.items()}),
            dataclasses.replace(tp, **{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))


def _np(x):
    return np.array(x).copy()


def _mutants():
    """``(name, jax plan, port plan, compact_grid, kdim)`` for the clean
    plans and one corruption of each kind the checks look for."""
    jp, tp = _plan_pair()
    nnz, idx = _np(jp.nnz), _np(jp.idx)
    rs, wr, wk = (_np(x) for x in jp.workqueue())
    r2 = int(np.argmax(nnz >= 2))
    out = [("clean", jp, tp, g, None) for g in ("ragged", *GRIDS)]
    for g in ("ragged", *GRIDS):
        dup = idx.copy()
        dup[r2, 1] = dup[r2, 0]
        out.append((f"dup-idx-{g}", *_replace_both(jp, tp, idx=dup), g, None))
        oob = idx.copy()
        oob[r2, 0] = jp.k_blocks + 2
        out.append((f"idx-oob-{g}", *_replace_both(jp, tp, idx=oob), g, None))
    rs_bad = rs.copy()
    rs_bad[len(rs) // 2] += 1
    out.append(("row-starts", *_replace_both(jp, tp, row_starts=rs_bad), "ragged", None))
    wr_oob = wr.copy()
    wr_oob[0] = jp.block_rows + 7
    out.append(("work-row-oob", *_replace_both(jp, tp, work_row=wr_oob), "ragged", None))
    wk_bad = wk.copy()
    t = int(np.argmax(nnz[wr[: int(rs[-1])]] > 0))
    wk_bad[t] = (wk_bad[t] + 1) % jp.k_blocks
    out.append(("work-kblk", *_replace_both(jp, tp, work_kblk=wk_bad), "ragged", None))
    wk_oob = wk.copy()
    wk_oob[t] = jp.k_blocks
    out.append(("work-kblk-oob", *_replace_both(jp, tp, work_kblk=wk_oob), "ragged", None))
    total = int(rs[-1])
    j = next(j for j in range(1, total) if wr[j] != wr[0])
    wr_swap = wr.copy()
    wr_swap[0], wr_swap[j] = wr_swap[j], wr_swap[0]
    out.append(("work-row-swap", *_replace_both(jp, tp, work_row=wr_swap), "ragged", None))
    for g in GRIDS:
        out.append((f"short-kdim-{g}", jp, tp, g, 1))
        out.append((f"kdim-past-idx-{g}", jp, tp, g, jp.k_blocks + 1))
        out.append((f"kdim-zero-{g}", jp, tp, g, 0))
    return out


MUTANTS = _mutants()


def _rule_splits(kb, sms=132):
    """Every split count the launch's rule gives a row of ``kb`` K blocks,
    over output tile counts from 1 to past the card's resident capacity."""
    return sorted({tspmm.kernel_splits(tiles, kb, sms, chunks=c) for tiles in range(1, 4 * sms)
                   for c in (1, 2, 8)})


SPLITS = _rule_splits(16)  # the plans' Kb


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", range(len(MUTANTS)), ids=[m[0] for m in MUTANTS])
def test_check_grid_finds_the_jax_codes(case, splits):
    name, jp, tp, grid, kdim = MUTANTS[case]
    wq = (lambda p: p.workqueue()) if grid == "ragged" else (lambda p: None)
    want = _codes(jcheck_grid(jp.nnz, jp.idx, compact_grid=grid, workqueue=wq(jp), kdim=kdim))
    got = _codes(check_grid(tp.nnz, tp.idx, compact_grid=grid, workqueue=wq(tp), kdim=kdim,
                            splits=splits))
    assert got == want, name
    assert (want == []) == name.startswith("clean")


@pytest.mark.parametrize("case", range(len(MUTANTS)), ids=[m[0] for m in MUTANTS])
def test_verify_plan_finds_the_jax_codes(case):
    name, jp, tp, _, _ = MUTANTS[case]
    for level in ("boundary", "full"):
        assert _codes(verify_plan(tp, level=level)) == _codes(jverify_plan(jp, level=level)), name


def test_check_plan_grid_models_the_launch_split():
    """A clean plan verifies at every split count the launch's rule gives it
    (each at most Kb), and the CUDA model ignores a corrupt tail past
    ``nnz`` (the kernel never reads it; ``verify_plan`` reports it)."""
    _, tp = _plan_pair(seed=4, density=0.6)
    splits = _rule_splits(tp.k_blocks)
    assert splits[0] == 1 and splits[-1] <= tp.k_blocks and len(splits) > 2
    for grid in ("ragged", *GRIDS):
        for s in splits:
            assert check_plan_grid(tp, nb=3, compact_grid=grid, splits=s) == []
    idx = tp.idx.clone()
    r = int(torch.nonzero(tp.nnz < tp.k_blocks)[0])
    idx[r, -1] = tp.k_blocks + 5
    bad = dataclasses.replace(tp, idx=idx)
    assert check_plan_grid(bad, compact_grid="v1") == []
    assert "plan.idx-bounds" in _codes(verify_plan(bad))

