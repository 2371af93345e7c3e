"""The scheduled-form codec of ``repro_torch.core.compress`` and
``repro_torch.checkpoint.codec`` against JAX's, on the CPU.

The same seeded numpy streams go through both packages.  ``compress`` is
held bit for bit (values, ``sel``, ``advance``, ``n_cycles``) over
densities, stream lengths ``T`` of 1, 2, 3 (shorter than the window), 96
and 257, and lookahead 1 and 2; ``decompress`` round-trips exactly;
``simulate_macs`` counts the same cycles and its fp32 accumulator is within
1e-6 relative of JAX's (the port sums each cycle's lanes by halves and the
cycles in order, as XLA does on the CPU, so they agree to the bit); the
codec's dicts are equal key for key, dtype for dtype and value for value,
and each package decodes the other's.  JAX's own codec cases
(``tests/test_compress.py``, ``tests/test_codec.py``) run through both.

The schedule kernel (``td_schedule_kernel``) runs only on the card; here
its wrapper is driven against a spy library (one call per schedule, the
arguments the ``.cu`` struct declares, no CPU tensor ever reaching it), and
the kernel's bit arithmetic is re-enacted in Python on the tables the
wrapper passes and held to the plain loop.
"""
import contextlib
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import codec as jcodec
from repro.core import compress as jcompress
from repro.core import decompress as jdecompress
from repro.core import simulate_macs as jsimulate_macs
from repro_torch.checkpoint import codec as tcodec
from repro_torch.core import Scheduled, compress, decompress, simulate_macs
from repro_torch.kernels import _build, block_mask, schedule


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream(seed, t, density, n_lanes=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n_lanes)).astype(np.float32)
    return np.where(rng.random((t, n_lanes)) < density, x, np.float32(0))


# ---------------------------------------------------------------------------
# compress / decompress / simulate_macs against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("t", [1, 2, 3, 96, 257])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_compress_bit_equal_to_jax(density, t, lookahead):
    x = _stream(t * 7 + int(density * 10), t, density)
    j = jcompress(jnp.asarray(x), lookahead=lookahead)
    p = compress(torch.from_numpy(x), lookahead=lookahead)
    assert p.sel.dtype == torch.int32 and p.advance.dtype == torch.int32
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(p.sel.numpy(), np.asarray(j.sel))
    np.testing.assert_array_equal(p.advance.numpy(), np.asarray(j.advance))
    assert int(p.n_cycles) == int(j.n_cycles)
    back = decompress(p, t=t, lookahead=lookahead)
    np.testing.assert_array_equal(back.numpy(), x)


def test_empty_stream_raises_in_both_packages():
    with pytest.raises(TypeError):  # JAX's dynamic_slice on a 0-row buffer
        jcompress(jnp.zeros((0, 16), jnp.float32))
    with pytest.raises(ValueError):
        compress(torch.zeros((0, 16)))
    with pytest.raises(ValueError):
        simulate_macs(torch.zeros((0, 16)), torch.zeros((0, 16)))


@pytest.mark.parametrize("n_lanes", [4, 7])
def test_other_lane_counts_equal_jax(n_lanes):
    x = _stream(n_lanes, 40, 0.4, n_lanes)
    j = jcompress(jnp.asarray(x), n_lanes=n_lanes)
    p = compress(torch.from_numpy(x), n_lanes=n_lanes)
    np.testing.assert_array_equal(p.sel.numpy(), np.asarray(j.sel))
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(decompress(p, t=40, n_lanes=n_lanes).numpy(), x)


def test_decompress_reads_jax_scheduled_form():
    x = _stream(3, 64, 0.3)
    j = jcompress(jnp.asarray(x))
    s = Scheduled(*(torch.from_numpy(np.array(f)) for f in j))
    np.testing.assert_array_equal(decompress(s, t=64).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jdecompress(j, t=64)), decompress(s, t=64).numpy())


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("two_side", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_macs_equals_jax(seed, two_side, lookahead):
    rng = np.random.default_rng(seed)
    t = 48
    a = (rng.standard_normal((t, 16)) * (rng.random((t, 16)) > 0.5)).astype(np.float32)
    b = (rng.standard_normal((t, 16)) * (rng.random((t, 16)) > 0.4)).astype(np.float32)
    j_acc, j_cyc = jsimulate_macs(jnp.asarray(a), jnp.asarray(b), lookahead=lookahead,
                                  two_side=two_side)
    acc, cyc = simulate_macs(torch.from_numpy(a), torch.from_numpy(b), lookahead=lookahead,
                             two_side=two_side)
    assert int(cyc) == int(j_cyc)
    assert acc.dtype == torch.float32
    np.testing.assert_allclose(float(acc), float(j_acc), rtol=1e-6)


def test_simulate_macs_schedules_a_batch_of_streams_independently():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((3, 30, 16)) * (rng.random((3, 30, 16)) > 0.5)).astype(np.float32)
    b = (rng.standard_normal((3, 30, 16)) * (rng.random((3, 30, 16)) > 0.5)).astype(np.float32)
    acc, cyc = simulate_macs(torch.from_numpy(a), torch.from_numpy(b))
    for i in range(3):
        j_acc, j_cyc = jsimulate_macs(jnp.asarray(a[i]), jnp.asarray(b[i]))
        assert int(cyc[i]) == int(j_cyc)
        np.testing.assert_allclose(float(acc[i]), float(j_acc), rtol=1e-6)


def test_simulate_macs_accumulates_fp64_in_fp64():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((20, 16)) * (rng.random((20, 16)) > 0.5)
    acc, _ = simulate_macs(torch.from_numpy(a), torch.from_numpy(a))
    assert acc.dtype == torch.float64
    np.testing.assert_allclose(float(acc), float(np.sum(a * a)), rtol=1e-12)


# JAX's tests/test_compress.py, through both packages


@pytest.mark.parametrize("seed", [0, 11, 12345])
@pytest.mark.parametrize("sparsity", [0.2, 0.5, 0.9])
def test_roundtrip_exact_in_both(seed, sparsity):
    rng = np.random.default_rng(seed)
    t = 24
    x = rng.standard_normal((t, 16)).astype(np.float32)
    x[rng.random((t, 16)) < sparsity] = 0.0
    for enc, dec in ((jcompress(jnp.asarray(x)), None), (compress(torch.from_numpy(x)), None)):
        dec = (jdecompress(enc, t=t) if isinstance(enc.values, jnp.ndarray)
               else decompress(enc, t=t))
        assert (np.asarray(dec) == x).all()
        assert int(enc.n_cycles) <= t


def test_compression_ratio_tracks_sparsity():
    rng = np.random.default_rng(0)
    t = 96
    dense = rng.standard_normal((t, 16)).astype(np.float32)
    sparse = dense * (rng.random((t, 16)) > 0.85)
    assert int(compress(torch.from_numpy(dense)).n_cycles) == t
    r_sparse = int(compress(torch.from_numpy(sparse)).n_cycles)
    assert r_sparse == int(jcompress(jnp.asarray(sparse)).n_cycles) and r_sparse < t / 2


@pytest.mark.parametrize("two_side", [True, False])
def test_mac_fidelity(two_side):
    rng = np.random.default_rng(1)
    t = 20
    a = (rng.standard_normal((t, 16)) * (rng.random((t, 16)) > 0.5)).astype(np.float32)
    b = (rng.standard_normal((t, 16)) * (rng.random((t, 16)) > 0.5)).astype(np.float32)
    acc, cycles = simulate_macs(torch.from_numpy(a), torch.from_numpy(b), two_side=two_side)
    np.testing.assert_allclose(float(acc), np.sum(a * b, dtype=np.float32), rtol=1e-5, atol=1e-5)
    assert int(cycles) <= t


# ---------------------------------------------------------------------------
# the checkpoint codec against JAX's
# ---------------------------------------------------------------------------


def _codec_cases():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[rng.random(w.shape) < 0.8] = 0.0  # 80% pruned
    odd = rng.standard_normal((37, 11)).astype(np.float32)
    odd[rng.random(odd.shape) < 0.6] = 0.0  # 407 elements: the last row is padded
    dense = rng.standard_normal((32, 32)).astype(np.float32)  # below min_sparsity
    w16 = (rng.standard_normal((48, 32)) * (rng.random((48, 32)) > 0.7)).astype(ml_dtypes.bfloat16)
    return {"sparse": w, "odd": odd, "dense": dense, "bf16": w16}


@pytest.mark.parametrize("case", ["sparse", "odd", "dense", "bf16"])
def test_encode_dicts_equal_jax(case):
    arr = _codec_cases()[case]
    j = jcodec.encode(arr)
    p = tcodec.encode(arr, device="cpu")
    assert sorted(p) == sorted(j)
    for k in j:
        jv, pv = np.asarray(j[k]), np.asarray(p[k])
        assert (pv.dtype, pv.shape) == (jv.dtype, jv.shape), k
        np.testing.assert_array_equal(pv.view(np.uint16) if pv.dtype == ml_dtypes.bfloat16 else pv,
                                      jv.view(np.uint16) if jv.dtype == ml_dtypes.bfloat16 else jv)
    assert tcodec.compressed_bytes(p) == jcodec.compressed_bytes(j)


@pytest.mark.parametrize("case", ["sparse", "odd", "dense", "bf16"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_codec_decodes_across_packages(case, direction):
    arr = _codec_cases()[case]
    if direction == "jax_to_torch":
        out = tcodec.decode(jcodec.encode(arr), device="cpu")
    else:
        out = jcodec.decode(tcodec.encode(arr, device="cpu"))
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


def test_codec_footprint_shrinks_with_sparsity():
    w = _codec_cases()["sparse"]
    d = tcodec.encode(w, device="cpu")
    assert int(d["mode"]) == 1 and tcodec.compressed_bytes(d) < 0.5 * w.nbytes


def test_codec_takes_a_bfloat16_tensor():
    """numpy has no bfloat16 without JAX's dtype package: a tensor's values
    travel as their uint16 bit pattern and come back as a tensor."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)).bfloat16()
    w = torch.where(torch.from_numpy(rng.random((40, 24)) < 0.6), torch.zeros((), dtype=w.dtype), w)
    d = tcodec.encode(w, device="cpu")
    assert d["values"].dtype == np.uint16 and str(d["dtype"]) == tcodec.BF16_BITS == "bfloat16_bits"
    back = tcodec.decode(d, device="cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), w.view(torch.int16))
    dense = torch.ones((8, 8), dtype=torch.bfloat16)
    assert torch.equal(tcodec.decode(tcodec.encode(dense, device="cpu"), device="cpu"), dense)


def test_jax_decode_never_misreads_a_bfloat16_tensors_bits():
    """The bit-pattern form's ``dtype`` is no numpy dtype: JAX's decode of a
    compressed one raises rather than casting the ``uint16`` bits as
    numbers, and of a dense one returns those bits unchanged."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)).bfloat16()
    sparse = torch.where(torch.from_numpy(rng.random((40, 24)) < 0.6), torch.zeros((), dtype=w.dtype), w)
    d = tcodec.encode(sparse, device="cpu")
    assert int(d["mode"]) == 1
    with pytest.raises(TypeError):
        jcodec.decode(d)
    dense = tcodec.encode(w, device="cpu")
    assert int(dense["mode"]) == 0
    got = jcodec.decode(dense)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, w.view(torch.int16).numpy().view(np.uint16))


# ---------------------------------------------------------------------------
# the schedule kernel's wrapper, with a spy in place of the built library
# ---------------------------------------------------------------------------


class _SpyLibrary:
    def __init__(self):
        self.calls, self.rc = [], 0

    def td_schedule(self, args_ref, stream):
        a = args_ref._obj
        self.calls.append({f: getattr(a, f) for f, _ in _build.ScheduleArgs._fields_})
        self.calls[-1]["opt_step"] = list(a.opt_step)
        self.calls[-1]["opt_rot"] = list(a.opt_rot)
        self.calls[-1]["level_mask"] = list(a.level_mask)
        self.calls[-1]["z_bytes"] = ctypes.string_at(a.z, a.S * a.T * a.N)  # what the kernel would read
        return self.rc


@pytest.fixture
def spy(monkeypatch):
    """A spy library behind the wrapper; ``spy.card(True)`` makes CPU
    tensors look like card tensors to the dispatch."""
    lib = _SpyLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    lib.card = lambda on: monkeypatch.setattr(block_mask, "on_card", lambda t: on)
    schedule.reset_launch_counts()
    return lib


@pytest.mark.parametrize("lookahead", [1, 2])
def test_a_schedule_on_the_card_is_one_library_call(spy, lookahead):
    spy.card(True)
    z = torch.from_numpy(np.random.default_rng(0).random((5, 33, 16)) < 0.5)
    sel, adv, n = schedule.schedule_streams(z, lookahead=lookahead)
    assert len(spy.calls) == 1 and schedule.LAUNCHES["td_schedule_kernel"] == 1
    args = spy.calls[0]
    steps, rot, masks = schedule.schedule_tables(16, lookahead)
    assert (args["S"], args["T"], args["N"], args["depth"]) == (5, 33, 16, lookahead + 1)
    assert (args["n_options"], args["n_levels"], args["vec"]) == (len(steps), len(masks), 1)
    assert args["opt_step"][:len(steps)] == steps and args["opt_rot"][:len(steps)] == rot
    assert args["level_mask"][:len(masks)] == masks
    assert args["sel"] == sel.data_ptr() and args["advance"] == adv.data_ptr()
    assert args["n_cycles"] == n.data_ptr()
    # the wrapper fills the rows past n_cycles; the kernel writes the rest
    assert sel.dtype == torch.int8 and bool((sel == len(steps)).all()) and not adv.any()


@pytest.mark.parametrize("entry", ["schedule_streams", "compress", "simulate_macs"])
def test_a_permuted_operand_reaches_the_kernel_row_major(spy, entry):
    """The kernel reads ``z`` as row-major ``[S, T, N]`` bytes: a transposed
    view (its ``!= 0`` keeps the permuted strides) reaches it copied into
    that order."""
    spy.card(True)
    x = torch.from_numpy(_stream(3, 16, 0.5, n_lanes=40)).T  # a [40, 16] stream, lanes contiguous in memory
    assert not x.is_contiguous()
    if entry == "schedule_streams":
        schedule.schedule_streams(x.unsqueeze(0))
    elif entry == "compress":
        compress(x)
    else:
        simulate_macs(torch.ones_like(x), x, two_side=False)
    assert len(spy.calls) == 1
    assert spy.calls[0]["z_bytes"] == (x != 0).numpy().astype(np.uint8).tobytes()


def test_a_failed_schedule_launch_raises(spy):
    spy.card(True)
    spy.rc = 719  # cudaErrorLaunchFailure
    with pytest.raises(RuntimeError, match="cudaError 719"):
        schedule.schedule_streams(torch.zeros((1, 8, 16), dtype=torch.bool))
    assert schedule.LAUNCHES["td_schedule_kernel"] == 0


def test_what_the_schedule_kernel_refuses_raises(spy):
    spy.card(True)
    for kw, shape in ((dict(lookahead=3), (1, 8, 16)), (dict(n_lanes=33), (1, 8, 33)),
                      (dict(), (1, 0, 16)), (dict(), (8, 16))):
        with pytest.raises(ValueError):
            schedule.schedule_streams(torch.zeros(shape), **kw)
    assert spy.calls == []


def test_a_cpu_tensor_never_reaches_the_schedule_library(spy):
    z = torch.from_numpy(np.random.default_rng(1).random((2, 20, 16)) < 0.4)
    x = torch.from_numpy(_stream(1, 20, 0.4))
    schedule.schedule_streams(z)
    compress(x)
    simulate_macs(x, x)
    tcodec.encode(x.numpy(), device="cpu")
    assert spy.calls == []


def test_schedule_arguments_match_the_cuda_struct():
    """``ScheduleArgs`` lists the C struct's fields in its order, with the
    tables' lengths."""
    src = (Path(_build.CSRC) / "schedule.cu").read_text()
    body = src[src.index("struct TdScheduleArgs {"):].split("};")[0].split("{", 1)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [first.split()[-1].lstrip("*")] + [r.strip().lstrip("*") for r in rest]
    fields = [f if not hasattr(t, "_length_") else f"{f}[{t._length_}]"
              for f, t in _build.ScheduleArgs._fields_]
    assert names == fields


# the kernel's arithmetic (csrc/schedule.cu), re-enacted on Python ints


def _kernel_model(z: np.ndarray, n: int, lookahead: int):
    steps, rot, masks = schedule.schedule_tables(n, lookahead)
    depth, n_opt, t = lookahead + 1, len(steps), z.shape[0]
    rep = 32 % n == 0  # the kernel's replicated words: a rotation is a funnel shift
    full = 0xFFFFFFFF if rep else (1 << n) - 1

    def replicate(x):
        sh = n
        while sh < 32:
            x |= (x << sh) & 0xFFFFFFFF
            sh <<= 1
        return x

    def rot_down(x, r):
        if rep:
            return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF if r else x
        return ((x | (x << n)) >> r) & full

    def rot_up(x, r):
        if rep:
            return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF if r else x
        return rot_down(x, 0 if r == 0 else n - r)

    def load(row):
        if n % 4:
            return sum(int(b != 0) << i for i, b in enumerate(row))
        w = 0
        for k in range(n // 4):
            v = int.from_bytes(bytes(int(b) for b in row[4 * k:4 * k + 4]), "little") & 0x01010101
            w |= ((((v * 0x01020408) & 0xFFFFFFFF) >> 24) & 0xF) << (4 * k)
        return w

    def spread4(x):
        return (x * 0x00204081) & 0x01010101

    rows = [load(z[r]) for r in range(t)] + [0] * 6  # rows >= T are zero
    rows = [replicate(w) for w in rows] if rep else rows
    w = [rows[0], rows[1], rows[2] if depth > 2 else 0]
    nxt, p = depth, 0
    sel, adv = np.full((t, n), n_opt, np.int8), np.zeros(t, np.int8)
    c = 0
    while p < t:
        q, picked = [0, 0, 0, 0], 0
        for m in masks:
            avail, gone = replicate(m) if rep else m, [0, 0, 0]
            for o in range(n_opt):
                take = rot_down(w[steps[o]], rot[o]) & avail
                avail &= ~take
                picked |= take
                for b in range(3):
                    if o >> b & 1:
                        q[b] |= take
                gone[steps[o]] |= rot_up(take, rot[o])
            w = [w[k] & ~gone[k] for k in range(3)]
        for b in range(4):
            if n_opt >> b & 1:
                q[b] |= full & ~picked
        a = 1
        if w[0] == 0 and w[1] == 0:
            a = 3 if depth > 2 and w[2] == 0 else 2
        if n % 4 == 0:
            out = b"".join((spread4(q[0] >> k & 15) | spread4(q[1] >> k & 15) << 1
                            | spread4(q[2] >> k & 15) << 2 | spread4(q[3] >> k & 15) << 3
                            ).to_bytes(4, "little") for k in range(0, n, 4))
            sel[c] = np.frombuffer(out, np.int8)
        else:
            sel[c] = [sum((q[b] >> i & 1) << b for b in range(4)) for i in range(n)]
        adv[c] = a
        c, p = c + 1, p + a
        r0, r1, r2 = rows[nxt], rows[nxt + 1], rows[nxt + 2]
        if depth > 2:
            w = [w[1], w[2], r0] if a == 1 else [w[2], r0, r1] if a == 2 else [r0, r1, r2]
        else:
            w = [w[1], r0, 0] if a == 1 else [r0, r1, 0]
        nxt += a
    return sel, adv, c


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 8, 12, 16, 32])
def test_the_kernels_bit_arithmetic_equals_the_plain_loop(n_lanes, lookahead):
    rng = np.random.default_rng(n_lanes)
    for density in (0.0, 0.3, 0.7, 1.0):
        for t in (1, 3, 41):
            z = (rng.random((t, n_lanes)) < density).astype(np.uint8)
            sel, adv, c = _kernel_model(z, n_lanes, lookahead)
            rs, ra, rc = schedule.schedule_streams_ref(torch.from_numpy(z[None]), n_lanes, lookahead)
            np.testing.assert_array_equal(sel, rs[0].numpy())
            np.testing.assert_array_equal(adv, ra[0].numpy())
            assert c == int(rc[0])
