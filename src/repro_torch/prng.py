"""JAX's default PRNG, replayed bit for bit in PyTorch (the plain version).

``jax.random`` is a defined algorithm: the Threefry-2x32 hash (20 rounds) on
counters, with the "partitionable" counter layout that the installed JAX
uses by default (``jax_threefry_partitionable``).  This module is the port's
own copy of the pieces the JAX serve engine draws through:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)`` (``threefry_seed``): the
  words ``[hi, lo]`` of the seed.  Under JAX's default 32-bit mode the seed
  wraps to 32 bits first, so ``hi`` is 0.
* :func:`fold_in` and :func:`split` are ``jax.random.fold_in`` and the
  foldlike ``jax.random.split``: ``fold_in(k, d)`` hashes the counter
  ``(0, d)``, ``split(k, n)[j]`` the counter ``(0, j)``, each new key the
  hash's two output words.
* :func:`random_bits` gives 32 bits a position: ``bits1 ^ bits2`` of the hash
  of the position's flat index as a 64-bit counter ``(hi, lo)``.
* :func:`uniform` fills the 23 mantissa bits of a float in ``[1, 2)`` from
  the top of those bits, subtracts 1, scales to ``[minval, maxval)`` and
  clamps below at ``minval``; :func:`gumbel` is ``-log(-log(u))`` of the
  uniform on ``[tiny, 1)`` (JAX's mode ``"low"``); :func:`categorical` is
  ``argmax(gumbel + logits)`` over the last axis, the first index on ties
  and the first NaN where there is one (``jnp.argmax``'s rule).
* :func:`normal` is ``jax.random.normal(key, shape, float32)``: the uniform
  on ``[nextafter(-1, 0), 1)``, XLA's float32 ``erf_inv`` of it, times
  float32 ``sqrt(2)``.  It can start anywhere in a leaf (:func:`block_layout`):
  an element's bits depend only on its flat index, so one layer of a stacked
  leaf, or one rank's shard of it, is drawn without drawing the rest.

Keys are ``uint32 [..., 2]`` tensors, as JAX's raw keys; every function
takes a batch of keys (the leading axes) where JAX would need ``vmap``.
torch's ``uint32`` has few kernels, so the arithmetic runs in ``int64``
masked to 32 bits, on whatever device the key lies.  The sampler kernel
(:mod:`repro_torch.kernels.sample`) and the fill kernel
(:mod:`repro_torch.kernels.normal`) do the same on the card; this module is
their plain version.
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["prng_key", "fold_in", "split", "threefry2x32", "random_bits", "uniform", "gumbel",
           "categorical", "first_argmax", "block_layout", "flat_index", "normal", "normal_of_bits", "TINY"]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal float32, the lower end of :func:`gumbel`'s uniform
TINY = torch.finfo(torch.float32).tiny


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] 32-bit words, got shape {tuple(key.shape)}")
    k = key.to(torch.int64) & _M32
    return k[..., 0], k[..., 1]


def _key(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return torch.stack([k0, k1], dim=-1).to(torch.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` under the key
    words ``(k0, k1)``: int64 tensors of 32-bit values (broadcast together);
    returns the two output words likewise."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0, x1 = (x0 + k0) & _M32, (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as uint32 ``[2]``: ``[hi, lo]`` of the
    seed wrapped to 32 bits (JAX's default mode), so ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device).to(torch.uint32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys ``[..., 2]``; ``data`` an
    int or an integer tensor broadcast against the keys' batch (each taken
    mod 2**32)."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    return _key(*threefry2x32(k0, k1, torch.zeros_like(d), d))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for keys ``[..., 2]``: ``[..., num, 2]``."""
    k0, k1 = _words(key)
    j = torch.arange(num, dtype=torch.int64, device=key.device)
    return _key(*threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(j), j))


def _bits_at(key: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """32 random bits at each flat index of ``flat`` (int64) under each key
    ``[..., 2]``, as int64 ``[..., *flat.shape]``: the hash of the counter
    ``(flat >> 32, flat & 0xffffffff)``."""
    k0, k1 = _words(key)
    lead = (...,) + (None,) * flat.ndim
    b0, b1 = threefry2x32(k0[lead], k1[lead], flat >> 32, flat & _M32)
    return b0 ^ b1


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits a position of ``shape`` under each key ``[..., 2]``, as
    int64 ``[..., *shape]``."""
    return _bits_at(key, flat_index(shape, device=key.device))


def block_layout(shape, offset: int = 0, full=None, starts=None) -> tuple[tuple, tuple, int]:
    """``(shape, strides, first)`` of a block of a leaf: its flat indices
    are ``first + sum(i[d] * strides[d])``.  The block is the leaf's flat
    range from ``offset`` (``full`` ``None``), or the block of ``shape`` at
    ``starts`` in a leaf of shape ``full``, shifted by ``offset``."""
    shape = tuple(int(n) for n in shape)
    if full is None:
        return shape, tuple(math.prod(shape[d + 1:]) for d in range(len(shape))), int(offset)
    full, starts = tuple(int(n) for n in full), tuple(int(n) for n in starts)
    if not len(full) == len(starts) == len(shape) or any(
            s < 0 or n < 0 or s + n > f for f, s, n in zip(full, starts, shape)):
        raise ValueError(f"block {shape} at {starts} does not lie in a leaf of shape {full}")
    strides = tuple(math.prod(full[d + 1:]) for d in range(len(full)))
    return shape, strides, int(offset) + sum(s * st for s, st in zip(starts, strides))


def flat_index(shape, offset: int = 0, full=None, starts=None, device=None) -> torch.Tensor:
    """The flat indices (int64 ``shape``) of the block of a leaf that
    :func:`block_layout` names."""
    shape, strides, first = block_layout(shape, offset, full, starts)
    idx = torch.full(shape, first, dtype=torch.int64, device=device)
    for d, (n, stride) in enumerate(zip(shape, strides)):
        idx += (torch.arange(n, dtype=torch.int64, device=device) * stride).reshape((-1,) + (1,) * (len(shape) - 1 - d))
    return idx


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's 32-bit ``random_bits`` (``jax.random.bits(key, shape, uint32)``)
    for keys ``[..., 2]``: uint32 ``[..., *shape]``."""
    return _bits(key, shape).to(torch.uint32)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """Float32 in ``[0, 1)`` from the top 23 of 32 random bits (int64)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _scaled(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(minval, f * (maxval - minval) + minval)`` in float32, the
    multiply-add fused as XLA fuses it: the product of two floats is exact in
    float64, so the float64 sum rounded to float32 is the fused result (the
    double rounding could differ only where the float64 sum lands on a
    float32 midpoint)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    fused = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for keys
    ``[..., 2]``: float32 ``[..., *shape]``."""
    return _scaled(_unit(_bits(key, shape)), minval, maxval)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as an FMA unit rounds it (XLA's
    CPU code and the card both fuse these steps).  The product is exact in
    float64; the float64 sum is rounded to odd (its exact error by TwoSum
    picks the odd neighbour when the sum was inexact), and a float64 value
    rounded to odd, 29 bits past float32's, rounds to float32 as the exact
    value does."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _consts(*hexes: str) -> tuple[float, ...]:
    return tuple(float.fromhex(h) for h in hexes)


# XLA's float32 log1p on the CPU, for the arguments normal gives it: a
# rational function for |t| < sqrt(2) - 1, else Cephes' logf of 1 + t (the
# CPU backend's own log); and XLA's float32 erf_inv (two 9-term polynomials
# split at w = 5).  Every multiply-add pair below is one FMA, as the CPU
# backend's code contracts it (read off its LLVM IR and machine code for
# jax.random.normal, JAX 0.9.0); csrc/normal.cu keeps the same constants.
_LOG_A = _consts("0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4")
_LOG_B = _consts("-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555ca0p-3")
_LOG_C = _consts("0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.555554p-2")
_LOG_E_LO, _LOG_E_HI = _consts("-0x1.bd0106p-13", "0x1.63p-1")  # ln 2 in two parts
_SQRT_HALF, _LOG1P_SMALL = _consts("0x1.6a09e6p-1", "0x1.a8279ap-2")
_LOG1P_P = _consts("0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4", "0x1.e798ecp+5",
                   "0x1.c8e75ap+5", "0x1.40a202p+4")
_LOG1P_Q = _consts("0x1p+0", "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
                   "0x1.b0db14p+7", "0x1.e0f304p+5")
_ERFINV_LT5 = _consts("0x1.e2cb10p-26", "0x1.70966cp-22", "-0x1.d8e6aep-19", "-0x1.26b582p-18",
                      "0x1.ca65b6p-13", "-0x1.48a810p-10", "-0x1.11c9dep-8", "0x1.f91ec6p-3", "0x1.805c5ep+0")
_ERFINV_GE5 = _consts("-0x1.a3e136p-13", "0x1.a76ad6p-14", "0x1.61b8e4p-10", "-0x1.e17bcep-9",
                      "0x1.7824f6p-8", "-0x1.f38baep-8", "0x1.354afcp-7", "0x1.006db6p+0", "0x1.6a9efcp+1")
#: the lower end of normal's uniform, nextafter(-1, 0), and float32 sqrt(2)
NORMAL_LO, SQRT2 = _consts("-0x1.fffffep-1", "0x1.6a09e6p+0")


def _log1p(t: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p(t)`` for ``t`` in ``(-1, 0]``; there ``1 +
    t`` is a positive normal float and none of the log's special cases
    (zero, negative, infinite arguments) can arise."""
    u = t + 1.0
    bits = u.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # u = m * 2**e, m in [0.5, 1)
    low = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    z = xm * xm
    z3 = z * xm
    poly = lambda c: _fma(xm, _fma(xm, _f32(c[0], t), _f32(c[1], t)), _f32(c[2], t))
    s = _fma(z3, _fma(z3, _fma(z3, poly(_LOG_A), poly(_LOG_B)), poly(_LOG_C)), e * _LOG_E_LO)
    big = _fma(e, _f32(_LOG_E_HI, t), s + _fma(_f32(-0.5, t), z, xm))
    t2 = t * t
    p, q = _f32(_LOG1P_P[0], t), _f32(1.0, t)
    for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        p, q = _fma(t, p, _f32(cp, t)), _fma(t, q, _f32(cq, t))
    small = t + _fma(_f32(-0.5, t), t2, (t * t2) * (p / q))
    return torch.where(t.abs() < _LOG1P_SMALL, small, big)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` for ``x`` in ``(-1, 1)``."""
    lg = _log1p(x * -x)  # -w
    lt5 = lg > -5.0
    root = torch.sqrt(-lg.double()).float()  # rounded once (torch's float32 CPU sqrt is not)
    w = torch.where(lt5, -2.5 - lg, root - 3.0)
    p = torch.where(lt5, _f32(_ERFINV_LT5[0], x), _f32(_ERFINV_GE5[0], x))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(w, p, torch.where(lt5, _f32(a, x), _f32(b, x)))
    return x * p


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 standard normals from 32 random bits a draw (int64), as
    ``jax.random.normal`` makes them: the uniform on ``[NORMAL_LO, 1)``
    (at most ``1 - 3 * 2**-24``, so ``erf_inv``'s ``x = +-1`` case cannot
    arise), ``erf_inv``, times float32 ``sqrt(2)``."""
    u = torch.maximum(_unit(bits) * 2.0 + NORMAL_LO, _f32(NORMAL_LO, bits))  # x * 2 exact: one rounding
    return _erf_inv(u) * SQRT2


@contextlib.contextmanager
def _one_cpu_thread():
    """Run the block's CPU ops on one intra-op thread: :func:`normal` is
    some 500 small elementwise ops, and with more threads OpenMP's idle ones
    spin between them, so a reduced model's init ran slower at several
    times the CPU time and slowed every other process on the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def normal(key: torch.Tensor, shape=(), offset: int = 0, full=None, starts=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for keys ``[..., 2]``:
    float32 ``[..., *shape]``.  With ``offset`` (and ``full``, ``starts``)
    the block of a larger draw that :func:`block_layout` names: ``normal(k,
    (n,), offset=l * n)`` is layer ``l`` of ``normal(k, (L, n))``, and
    ``normal(k, s, full=f, starts=a)`` is the slice of ``normal(k, f)`` of
    shape ``s`` at ``a``."""
    with _one_cpu_thread():
        return normal_of_bits(_bits_at(key, flat_index(shape, offset, full, starts, device=key.device)))


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode ``"low"``) for keys
    ``[..., 2]``: float32 ``[..., *shape]``, ``-log(-log(u))`` of the uniform
    on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax(x, axis=-1)``: the first maximal index, the first NaN's
    where a row holds one; int64."""
    nan = torch.isnan(x)
    best = torch.argmax(torch.where(nan, torch.full_like(x, float("inf")), x), dim=-1)
    has_nan = nan.any(dim=-1)
    return torch.where(has_nan, torch.argmax(nan.to(torch.uint8), dim=-1), best)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of fp32
    ``logits [..., V]``, one key ``[..., 2]`` a row: int64 ``[...]``."""
    return first_argmax(gumbel(key, logits.shape[-1:]) + logits)
