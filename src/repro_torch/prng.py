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

Keys are ``uint32 [..., 2]`` tensors, as JAX's raw keys; every function
takes a batch of keys (the leading axes) where JAX would need ``vmap``.
torch's ``uint32`` has few kernels, so the arithmetic runs in ``int64``
masked to 32 bits, on whatever device the key lies.  The sampler kernel
(:mod:`repro_torch.kernels.sample`) does the same on the card in one launch;
this module is its plain version.
"""
from __future__ import annotations

import math

import torch

__all__ = ["prng_key", "fold_in", "split", "threefry2x32", "random_bits", "uniform", "gumbel",
           "categorical", "first_argmax", "TINY"]

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


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits a position of ``shape`` under each key ``[..., 2]``, as
    int64 ``[..., *shape]``."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    lead = (...,) + (None,) * len(shape)
    b0, b1 = threefry2x32(k0[lead], k1[lead], (flat >> 32).reshape(shape), (flat & _M32).reshape(shape))
    return b0 ^ b1


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
