"""repro_torch.prng and the sampler's wrapper against jax.random on the CPU.

``prng.py`` replays JAX's Threefry key streams: keys, ``fold_in``,
``split``, 32-bit ``random_bits`` and ``uniform`` equal ``jax.random``'s bit
for bit (seed 0, a seed past 2**31 and one past 2**32 among them).

``gumbel`` is ``-log(-log(u))`` of a bit-equal ``u``; torch's CPU ``log``
and XLA's CPU ``log`` are different float32 approximations.  Measured over
2**20 draws: the inner ``log`` differs by one ulp on 14% of them, the outer
on 14%, never more; the Gumbel draws then differ by at most two ulps of
``max(|g|, 1)`` (an absolute bound: near ``g = 0`` one ulp of the inner log
is many ulps of ``g``).  On the card both the kernel and the plain version
take CUDA's ``logf``, the function XLA's GPU backend calls.  ``categorical``
tokens equal JAX's.

The sampler's CPU path (its plain version) equals the JAX engine's
``_sample_rows`` on a ``[B, V]`` batch with ``good`` masks and a NaN row:
called eagerly, as JAX's admission calls it (the row divided by the
temperature), and jitted, as its decode scan calls it (XLA multiplies by
the float32 reciprocal instead); keys advance as JAX's ``split`` where
``good`` and stay where not.  Its card path is driven with a spy library
in place of the built one: one launch a call, the arguments the kernel's
struct takes, a failed launch raising.
"""
import contextlib
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as jengine
from repro_torch import prng
from repro_torch.kernels import _build, block_mask
from repro_torch.kernels import sample as S

SEEDS = [0, 1, 42, 2**31 + 7, 2**32 + 3, -1]
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 5), (1000,)]
#: gumbel against JAX's on the CPU: ulps of max(|g|, 1) (measured; see above)
GUMBEL_ULPS = 2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert tkey.dtype == torch.uint32 and np.array_equal(_np(tkey), np.asarray(key))
    for data in (0, 1, 7, 2**31 + 3, 2**32 - 1):
        assert np.array_equal(_np(prng.fold_in(tkey, data)), np.asarray(jax.random.fold_in(key, data)))
    for num in (1, 2, 3, 5):
        assert np.array_equal(_np(prng.split(tkey, num)), np.asarray(jax.random.split(key, num)))
    # a batch of keys: JAX's vmap
    rids = np.arange(5, dtype=np.uint32)
    keys = prng.fold_in(tkey, torch.from_numpy(rids.astype(np.int64)))
    want = jax.vmap(lambda r: jax.random.fold_in(key, r))(rids)
    assert np.array_equal(_np(keys), np.asarray(want))
    assert np.array_equal(_np(prng.split(keys)), np.asarray(jax.vmap(jax.random.split)(want)))


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**32 + 3])
def test_random_bits_and_uniform_equal_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        assert np.array_equal(_np(prng.random_bits(tkey, shape)), want), shape
        for lo, hi in ((0.0, 1.0), (-3.7, 2.1), (1e-3, 5.0), (float(np.finfo(np.float32).tiny), 1.0)):
            want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
            got = _np(prng.uniform(tkey, shape, lo, hi))
            assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
                (shape, lo, hi)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_gumbel_within_the_stated_ulps_and_categorical_equal(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.gumbel(key, (1 << 16,), jnp.float32))
    got = _np(prng.gumbel(tkey, (1 << 16,)))
    assert np.all(np.isfinite(got))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)
    rng = np.random.default_rng(seed % 2**32)
    logits = (rng.standard_normal((64, 1000)) * 3).astype(np.float32)
    keys = jax.random.split(key, 64)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))
    got = _np(prng.categorical(torch.from_numpy(np.array(keys)), torch.from_numpy(logits)))
    assert np.array_equal(got, want)


def _batch(seed: int, b: int = 6, v: int = 1000):
    """fp32 logits with a NaN row (two NaNs: the first wins), an Inf row and
    a tied row, seeded keys, and a ``good`` mask that clears one row."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[1, [7, 300]] = np.nan
    logits[2] = np.inf
    logits[3] = 1.5  # every score ties but for the Gumbel draws
    keys = rng.integers(0, 2**32, size=(b, 2), dtype=np.uint64).astype(np.uint32)
    good = np.ones(b, bool)
    good[4] = False
    return logits, keys, good


@pytest.mark.parametrize("temperature", [0.8, 1.0, 0.3])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_sampler_cpu_path_equals_jax_sample_rows(temperature, reciprocal):
    logits, keys, good = _batch(int(temperature * 10) + reciprocal)
    splits = jax.vmap(lambda k: jax.random.split(k, 2))(jnp.asarray(keys))
    draw = jengine._sample_rows
    if reciprocal:
        draw = jax.jit(draw, static_argnums=2)
    want = np.where(good, np.asarray(draw(jnp.asarray(logits), splits[:, 1], temperature)), -1)
    assert want[1] == 7 and want[2] == 0  # the first NaN; an all-Inf row's first index
    tkeys = torch.from_numpy(keys.copy())
    got = S.sample_tokens(torch.from_numpy(logits), tkeys, temperature, torch.from_numpy(good), -1,
                          reciprocal=reciprocal)
    assert got.dtype == torch.int64 and np.array_equal(_np(got), want)
    assert np.array_equal(_np(tkeys), np.where(good[:, None], np.asarray(splits[:, 0]), keys))
    # the plain version is prng.categorical of the scaled rows under the subkeys
    scaled = torch.from_numpy(logits) * S.reciprocal_of(temperature) if reciprocal else \
        torch.from_numpy(logits) / temperature
    cat = prng.categorical(torch.from_numpy(np.array(splits[:, 1])), scaled)
    assert np.array_equal(_np(cat)[good], want[good])


def test_sampler_refuses_what_the_kernel_does_not_take():
    rows, keys, good = torch.zeros(2, 8), torch.zeros(2, 2, dtype=torch.uint32), torch.ones(2, dtype=torch.bool)
    for bad in ({"rows": rows.double()}, {"rows": rows[:, :0]}, {"keys": keys.long()}, {"keys": keys[:1]},
                {"good": good.int()}, {"good": good[:1]}, {"temperature": 0.0}):
        args = {"rows": rows, "keys": keys, "good": good, "temperature": 1.0, **bad}
        with pytest.raises(ValueError):
            S.sample_tokens(args["rows"], args["keys"], args["temperature"], args["good"])


class _SpyLibrary:
    """Records each ``td_sample`` call's arguments and writes the plain
    version's tokens and keys where the kernel would."""

    def __init__(self, want_tokens, want_keys):
        self.calls, self.rc = [], 0
        self.want = (want_tokens, want_keys)

    def td_sample(self, args_ref, stream):
        a = args_ref._obj
        self.calls.append({f: getattr(a, f) for f, _ in _build.SampleArgs._fields_})
        tok, keys = self.want
        ctypes.memmove(a.tokens, tok.data_ptr(), 8 * a.B)
        ctypes.memmove(a.keys, keys.data_ptr(), 8 * a.B)
        return self.rc


def test_sampler_card_path_is_one_launch_with_the_kernels_arguments(monkeypatch):
    """A "card" tensor (the CPU standing in) reaches the library once a call
    with the tensors' pointers and strides, the float32 temperature and its
    reciprocal, the workspace's maxima then counters; a nonzero return code
    raises and counts no launch."""
    logits, keys, good = _batch(5)
    rows = torch.from_numpy(logits).t().contiguous().t()  # column-major: strides (1, B)
    tkeys, tgood = torch.from_numpy(keys.copy()), torch.from_numpy(good)
    want_keys = tkeys.clone()
    want = S.sample_tokens_ref(rows, want_keys, 0.7, tgood, 3, reciprocal=True)
    lib = _SpyLibrary(want, want_keys)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    monkeypatch.setattr(block_mask, "on_card", lambda t: True)
    monkeypatch.setattr(block_mask, "sm_count", lambda dev: 132)
    S.reset_launch_counts()
    got = S.sample_tokens(rows, tkeys, 0.7, tgood, 3, reciprocal=True)
    assert torch.equal(got, want) and torch.equal(tkeys, want_keys)
    assert S.LAUNCHES == {"td_sample_kernel": 1} and len(lib.calls) == 1
    c = lib.calls[0]
    b, v = logits.shape
    assert (c["rows"], c["row_stride"], c["col_stride"]) == (rows.data_ptr(), 1, b)
    assert (c["keys"], c["good"], c["B"], c["V"], c["pad_id"], c["reciprocal"]) == \
        (tkeys.data_ptr(), tgood.data_ptr(), b, v, 3, 1)
    assert c["temperature"] == float(np.float32(0.7)) and c["inv"] == S.reciprocal_of(0.7)
    assert c["arrived"] - c["best"] == 8 * b and c["best"] % 8 == 0
    assert c["chunk"] == S.sample_geometry(b, v, 132)[1]
    lib.rc = 700
    with pytest.raises(RuntimeError, match="td_sample_kernel"):
        S.sample_tokens(rows, tkeys, 0.7, tgood, 3)
    assert S.LAUNCHES == {"td_sample_kernel": 1}


def test_sample_arguments_match_the_cuda_struct():
    """``SampleArgs`` lists the C struct's fields in its order."""
    src = (Path(_build.CSRC) / "sample.cu").read_text()
    body = src[src.index("struct TdSampleArgs {"):].split("};")[0].split("{", 1)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [first.split()[-1].lstrip("*")] + [r.strip().lstrip("*") for r in rest]
    assert names == [f for f, _ in _build.SampleArgs._fields_]


@pytest.mark.parametrize("b", [1, 4, 65535])
@pytest.mark.parametrize("v", [32000, 50280, 102400, 151936, 152064, 256000])
def test_sample_geometry_covers_every_position_once(b, v):
    """The grid ``sample_geometry`` gives, walked as ``td_sample_kernel``
    walks it (CTA ``x`` of a row from ``x * chunk``, each thread from its
    index in steps of the CTA's width, two positions a step), draws every
    position of every row exactly once; about ``SAMPLE_CTAS_PER_SM`` CTAs a
    SM, no CTA without a position."""
    sms, threads = 132, S.SAMPLE_THREADS
    ctas, chunk = S.sample_geometry(b, v, sms)
    assert chunk % 32 == 0 and (ctas - 1) * chunk < v <= ctas * chunk
    assert b * ctas >= min(S.SAMPLE_CTAS_PER_SM * sms, b) and (ctas == 1 or b * (ctas - 1) < S.SAMPLE_CTAS_PER_SM * sms)
    seen = np.zeros(v, np.int64)
    start = np.arange(ctas)[:, None] * chunk  # every row walks the same grid
    end = np.minimum(v, start + chunk)
    i = start + np.arange(threads)[None, :]
    while (live := i < end).any():  # the loop's step: positions i and i + threads
        np.add.at(seen, i[live], 1)
        second = live & (i + threads < end)
        np.add.at(seen, i[second] + threads, 1)
        i = i + 2 * threads
    assert (seen == 1).all()
