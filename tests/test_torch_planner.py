"""The one-launch planner (``repro_torch.kernels.block_mask``) on the CPU.

* The plain versions the kernel is held to on the card
  (``ref.plan_blocks_csr_ref``, ``plan_from_mask_csr_ref``,
  ``transpose_plan_csr_ref``), reached through the public plan functions on
  CPU tensors, equal the JAX package's ``plan_blocks_csr``,
  ``plan_from_mask_csr`` and ``transpose_plan_csr`` bit for bit in all five
  int32 arrays, on numpy inputs made from a seed: one block row, one K
  block, 86 and 800 K blocks, all-zero rows, all-zero and dense masks,
  coarsen 2 / 4 / Nb, bool and int8 masks, transposed (strided) masks and
  operands, fp32 and bf16 values, a NaN in an otherwise zero block.
* Dispatch, with a spy in place of the built library: a plan of a tensor
  taken for a card's makes exactly one library call, in the right mode,
  with the operand's pointer, shape and strides, and returns what the
  library wrote at the output pointers; a nonzero return code raises (no
  fallback to the chain); a refused dtype raises ``TypeError``; a CPU
  tensor never reaches the library.
* ``PlanArgs`` lists the C struct's fields in its order.
"""
import contextlib
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tensordash_spmm as jspmm
from repro_torch.kernels import _build, block_mask, ref
from repro_torch.kernels import tensordash_spmm as tspmm


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(j_arrays, t_tensors):
    assert len(j_arrays) == len(t_tensors) == 5
    for j, t in zip(j_arrays, t_tensors):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _mask(rng, mb, kb, kind):
    """An int8 block mask ``[mb, kb]`` of the named kind."""
    if kind == "zero":
        return np.zeros((mb, kb), np.int8)
    if kind == "dense":
        return np.ones((mb, kb), np.int8)
    m = (rng.random((mb, kb)) < 0.35).astype(np.int8)
    if kind == "zero_rows" and mb > 1:
        m[::2] = 0
    return m


def _operand(rng, mask, bm, bk):
    """``[Mb*bm, Kb*bk]`` fp32 whose nonzero blocks are those of ``mask``;
    an effectual block holds a few nonzeros among zeros."""
    mb, kb = mask.shape
    vals = rng.standard_normal((mb * bm, kb * bk)).astype(np.float32)
    keep = rng.random(vals.shape) < 0.3
    keep.reshape(mb, bm, kb, bk)[:, 0, :, 0] = True  # one sure nonzero per block
    blocks = np.repeat(np.repeat(mask != 0, bm, axis=0), bk, axis=1)
    return np.where(keep & blocks, vals, 0.0).astype(np.float32)


#: (Mb, Kb, bm, bk): one block row, one K block, the decode gate mask's 86 K
#: blocks, the LM head db transpose's 800
SHAPES = [(1, 5, 4, 8), (6, 1, 4, 8), (1, 1, 4, 8), (3, 86, 2, 2), (2, 800, 2, 1), (9, 7, 4, 8)]
KINDS = ["mixed", "zero_rows", "zero", "dense"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mb,kb,bm,bk", SHAPES)
def test_plan_blocks_csr_equals_jax(mb, kb, bm, bk, kind, dtype):
    rng = np.random.default_rng(mb * 1000 + kb)
    a = _operand(rng, _mask(rng, mb, kb, kind), bm, bk)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ta = torch.from_numpy(a).to(dtype)
    _eq(jspmm.plan_blocks_csr(jnp.asarray(a, jdt), bm, bk), tspmm.plan_blocks_csr(ta, bm, bk))
    # the transposed operand as a strided view, as the side-B LM head passes it
    _eq(jspmm.plan_blocks_csr(jnp.asarray(a.T, jdt), bk, bm), tspmm.plan_blocks_csr(ta.T, bk, bm))
    assert not ta.T.is_contiguous() or min(a.shape) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_an_otherwise_zero_block_is_effectual(dtype):
    a = np.zeros((8, 32), np.float32)
    a[5, 17] = np.nan  # block (1, 2) at 4 x 8
    a[0, 3] = -0.0  # -0 is zero
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    got = tspmm.plan_blocks_csr(torch.from_numpy(a).to(dtype), 4, 8)
    _eq(jspmm.plan_blocks_csr(jnp.asarray(a, jdt), 4, 8), got)
    assert got[0].tolist() == [0, 1] and got[1][1, 0] == 2


#: (Mb, Nb, coarsen): 1, 2, 4 and Nb wherever they divide Nb (86 = 2 x 43)
MASK_SHAPES = [(mb, nb, c) for mb, nb in [(1, 8), (1, 86), (8, 86), (5, 4), (2, 800)]
               for c in sorted({1, 2, 4, nb}) if nb % c == 0]


@pytest.mark.parametrize("layout", ["int8", "bool", "int8_T", "bool_T"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mb,nb,coarsen", MASK_SHAPES)
def test_plan_from_mask_csr_equals_jax(mb, nb, coarsen, kind, layout):
    rng = np.random.default_rng(mb * 7 + nb)
    mask = _mask(rng, mb, nb, kind)
    dt = np.bool_ if layout.startswith("bool") else np.int8
    if layout.endswith("_T"):  # a strided view of a transposed buffer
        tmask = torch.from_numpy(np.ascontiguousarray(mask.T.astype(dt))).T
        assert not tmask.is_contiguous() or 1 in mask.shape
    else:
        tmask = torch.from_numpy(mask.astype(dt))
    want = jspmm.plan_from_mask_csr(jnp.asarray(mask.astype(dt)), coarsen=coarsen)
    _eq(want, tspmm.plan_from_mask_csr(tmask, coarsen=coarsen))
    for j, t in zip(want[:2], tspmm.plan_from_mask(tmask, coarsen=coarsen)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mb,kb", [(1, 1), (1, 9), (8, 1), (8, 86), (800, 8), (3, 86)])
def test_transpose_plan_csr_equals_jax(mb, kb, kind):
    rng = np.random.default_rng(mb + kb)
    nnz, idx = jspmm.plan_from_mask(jnp.asarray(_mask(rng, mb, kb, kind)))
    tnnz, tidx = torch.from_numpy(np.array(nnz)), torch.from_numpy(np.array(idx))
    want = jspmm.transpose_plan_csr(nnz, idx)
    _eq(want, tspmm.transpose_plan_csr(tnnz, tidx))
    np.testing.assert_array_equal(np.asarray(want[0]), tspmm.transpose_plan(tnnz, tidx)[0].numpy())


def test_coarsen_must_divide_the_mask():
    with pytest.raises(ValueError):
        tspmm.plan_from_mask_csr(torch.ones(2, 6, dtype=torch.int8), coarsen=4)
    with pytest.raises(ValueError):
        tspmm.plan_blocks_csr(torch.ones(6, 8), 4, 8)


# ---------------------------------------------------------------------------
# dispatch, with a spy in place of the built library
# ---------------------------------------------------------------------------


def _view(addr, dtype, shape, strides):
    """A numpy view of memory at ``addr`` (strides in elements)."""
    item = np.dtype(dtype).itemsize
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = np.frombuffer((ctypes.c_byte * (extent * item)).from_address(addr), dtype=dtype)
    return np.lib.stride_tricks.as_strided(buf, shape, tuple(s * item for s in strides))


class _SpyLibrary:
    """Stands in for the built library: records each ``td_plan`` call's
    arguments and fills the outputs at their pointers with the plain
    chain's result, read from the input pointers as the kernel reads them."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def td_plan(self, args_ref, stream):
        p = args_ref._obj
        self.calls.append({f: getattr(p, f) for f, _ in _build.PlanArgs._fields_})
        if self.rc:
            return self.rc
        mode, rows, cols = block_mask.MODES[p.mode], p.R, p.C
        if mode in ("mask", "values"):
            shape = (rows * p.bm, cols * p.bk)
            if p.dtype == 0:
                x = torch.from_numpy(_view(p.x, np.float32, shape, (p.s0, p.s1)).copy())
            else:
                bits = _view(p.x, np.uint16, shape, (p.s0, p.s1)).astype(np.uint32) << 16
                x = torch.from_numpy(bits.view(np.float32))
            if mode == "mask":
                mask = ref.block_any_nonzero(x, p.bm, p.bk).numpy()
                _view(p.mask, np.int8, (rows, cols), (cols, 1))[...] = mask
                return 0
            plan = ref.plan_blocks_csr_ref(x, p.bm, p.bk)
        elif mode == "emitted":
            m = torch.from_numpy(_view(p.x, np.uint8, (rows, cols * p.bk), (p.s0, p.s1)).copy())
            plan = ref.plan_from_mask_csr_ref(m, coarsen=p.bk)
        else:
            fnnz = torch.from_numpy(_view(p.fnnz, np.int32, (cols,), (1,)).copy())
            fidx = torch.from_numpy(_view(p.fidx, np.int32, (cols, rows), (rows, 1)).copy())
            plan = ref.transpose_plan_csr_ref(fnnz, fidx)
        flat = rows * cols
        for ptr, n, t in zip((p.nnz, p.idx, p.row_starts, p.work_row, p.work_kblk),
                             (rows, flat, rows + 1, flat, flat), plan):
            _view(ptr, np.int32, (n,), (1,))[...] = t.reshape(-1).numpy()
        return 0


@pytest.fixture
def spy(monkeypatch):
    """A spy library behind the launcher; ``spy.card(True)`` makes CPU
    tensors count as a card's."""
    lib = _SpyLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    lib.card = lambda on: monkeypatch.setattr(block_mask, "on_card", lambda t: on)
    tspmm.reset_launch_counts()
    yield lib
    tspmm.reset_launch_counts()
    for key in [k for k in tspmm._ARRIVALS if k[0] is None]:
        del tspmm._ARRIVALS[key]


def _plans():
    """One call of each planner mode: (counter, call, plain result)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_operand(rng, _mask(rng, 4, 86, "zero_rows"), 2, 2)).to(torch.bfloat16)
    lm = torch.from_numpy(_operand(rng, _mask(rng, 6, 3, "mixed"), 8, 4))
    mask = torch.from_numpy(_mask(rng, 3, 8, "mixed"))
    nnz, idx = ref.mask_to_plan_ref(torch.from_numpy(_mask(rng, 5, 9, "zero_rows")))
    return [
        ("planner[values]", lambda: tspmm.plan_blocks_csr(a, 2, 2), ref.plan_blocks_csr_ref(a, 2, 2)),
        ("planner[values]", lambda: tspmm.plan_blocks_csr(lm.T, 4, 8), ref.plan_blocks_csr_ref(lm.T, 4, 8)),
        ("planner[emitted]", lambda: tspmm.plan_from_mask_csr(mask.T.contiguous().T, coarsen=2),
         ref.plan_from_mask_csr_ref(mask, coarsen=2)),
        ("planner[transpose]", lambda: tspmm.transpose_plan_csr(nnz, idx), ref.transpose_plan_csr_ref(nnz, idx)),
        ("block_zero_mask", lambda: (block_mask.block_zero_mask(lm.T, bm=4, bk=8),),
         (ref.block_any_nonzero(lm.T, 4, 8),)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_a_plan_on_the_card_is_one_library_call(spy, case):
    counter, call, want = _plans()[case]
    spy.card(True)
    got = call()
    assert len(spy.calls) == 1
    args = spy.calls[0]
    assert block_mask.COUNTERS[block_mask.MODES[args["mode"]]] == counter
    assert tspmm.launch_counts()[counter] == 1 and sum(tspmm.launch_counts().values()) == 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    if counter != "block_zero_mask":  # the five arrays share one allocation, idx first
        nnz, idx, row_starts, work_row, work_kblk = got
        assert (args["R"], args["C"]) == tuple(idx.shape)
        assert [args[f] for f in ("nnz", "idx", "row_starts", "work_row", "work_kblk")] == [
            t.data_ptr() for t in got]
        assert work_row.data_ptr() == idx.data_ptr() + 4 * idx.numel()
    assert bool(args["counter"]) == (counter == "planner[values]")  # the arrival counter


def test_operand_pointer_shape_and_strides_reach_the_kernel(spy):
    rng = np.random.default_rng(6)
    w = torch.from_numpy(_operand(rng, _mask(rng, 4, 6, "mixed"), 8, 16)).to(torch.bfloat16)
    spy.card(True)
    tspmm.plan_blocks_csr(w.T, 16, 8)  # lm_head.T: a transposed view, unit stride along rows
    args = spy.calls[0]
    assert (args["x"], args["s0"], args["s1"]) == (w.data_ptr(), 1, w.shape[1])
    assert (args["R"], args["C"], args["bm"], args["bk"], args["dtype"]) == (6, 4, 16, 8, 1)
    assert args["vec"] == int(w.data_ptr() % 16 == 0)  # 16 rows of bf16 = two 16-byte loads
    mask = torch.zeros(2, 12, dtype=torch.bool)
    tspmm.plan_from_mask_csr(mask, coarsen=3)
    args = spy.calls[1]
    assert (args["R"], args["C"], args["bk"], args["s0"], args["s1"]) == (2, 4, 3, 12, 1)


def test_a_failed_launch_raises_and_never_falls_back(spy):
    spy.rc = 719  # cudaErrorLaunchFailure
    spy.card(True)
    for counter, call, _ in _plans():
        with pytest.raises(RuntimeError, match="cudaError 719"):
            call()
    assert len(spy.calls) == 5
    assert all(v == 0 for v in tspmm.launch_counts().values())


def test_what_the_kernel_refuses_raises(spy):
    spy.card(True)
    with pytest.raises(TypeError):
        tspmm.plan_blocks_csr(torch.ones(8, 8, dtype=torch.float16), 4, 4)
    with pytest.raises(TypeError):
        tspmm.plan_from_mask_csr(torch.ones(2, 4, dtype=torch.int32))
    with pytest.raises(TypeError):
        tspmm.transpose_plan_csr(torch.ones(2, dtype=torch.int64), torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError):  # more K blocks a row than the kernel stages
        tspmm.plan_from_mask_csr(torch.ones(1, 24577, dtype=torch.int8))
    assert spy.calls == []


def test_a_cpu_tensor_never_reaches_the_library(spy):
    for _, call, want in _plans():
        got = call()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert spy.calls == []
    assert all(v == 0 for v in tspmm.launch_counts().values())


def test_plan_arguments_match_the_cuda_struct():
    """``PlanArgs`` lists the C struct's fields in its order."""
    src = (Path(_build.CSRC) / "block_mask.cu").read_text()
    body = src[src.index("struct TdPlanArgs {"):].split("};")[0].split("{", 1)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [first.split()[-1].lstrip("*")] + [r.strip().lstrip("*") for r in rest]
    assert names == [f for f, _ in _build.PlanArgs._fields_]
