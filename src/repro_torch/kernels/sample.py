"""The sampler: one decode step's per-slot key split and Gumbel-max draw
(new: no Pallas counterpart; XLA fuses this sampling into the JAX serve
engine's jitted decode scan, ``repro/serve/engine.py`` ``_decode_chunk``).

:func:`sample_tokens` takes fp32 logits ``[B, V]``, each slot's JAX key
``uint32 [B, 2]`` (updated in place) and a ``good [B]`` mask, and does what
the JAX engine does for a slot each step: split the key into ``(next,
sub)``, draw ``jax.random.categorical(sub, row / temperature)`` and keep
``next``; a slot whose ``good`` flag is clear emits ``pad_id`` and keeps
its key.  The scaled row is ``row / temperature`` (IEEE division, as the
JAX engine's eager admission computes it) or, with ``reciprocal``, ``row *
fp32(1 / temperature)``, which is what XLA makes of the division inside the
jitted decode step.

On a CPU tensor it runs the plain version, :func:`sample_tokens_ref`, built
from :mod:`repro_torch.prng`; on a CUDA tensor it makes one launch of
``td_sample_kernel`` (``csrc/sample.cu``) on the current stream, its grid
sized to the card's SMs (:func:`sample_geometry`), with no host read and no
allocation but the tokens, so a CUDA graph can capture it.
A failed build or launch raises.  :data:`LAUNCHES` counts the wrapper calls
that launched.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import block_mask

__all__ = ["sample_tokens", "sample_tokens_ref", "sample_geometry", "reciprocal_of", "LAUNCHES",
           "reset_launch_counts"]

#: calls of ``td_sample_kernel`` since :func:`reset_launch_counts`
LAUNCHES = {"td_sample_kernel": 0}
#: threads a CTA (``kThreads`` in csrc/sample.cu) and CTAs a SM the grid aims at
SAMPLE_THREADS, SAMPLE_CTAS_PER_SM = 256, 2
#: positions a row on the card (``kMaxV``: an index three CTA-widths past the end fits an int32)
MAX_V = 0x7FFFFC00


def sample_geometry(b: int, v: int, sms: int) -> tuple[int, int]:
    """``(ctas a row, positions a CTA)`` of the sampler's grid over ``b``
    rows of ``v`` logits on a card of ``sms`` SMs: about
    ``SAMPLE_CTAS_PER_SM`` CTAs a SM in all (at least one a row), each a
    contiguous chunk of a row, a multiple of 32 positions, so every SM gets
    the same draws in one wave.  CTA ``x`` of a row draws positions ``[x *
    chunk, min(v, (x + 1) * chunk))``."""
    want = max(1, -(-SAMPLE_CTAS_PER_SM * sms // b))
    chunk = -(-(-(-v // want)) // 32) * 32
    return -(-v // chunk), chunk


def reset_launch_counts() -> None:
    LAUNCHES["td_sample_kernel"] = 0


def reciprocal_of(temperature: float) -> float:
    """``1 / temperature`` rounded to float32, as XLA folds it."""
    return float(np.float32(1.0) / np.float32(temperature))


def _check(rows: torch.Tensor, keys: torch.Tensor, temperature: float, good: torch.Tensor) -> None:
    if rows.ndim != 2 or rows.dtype != torch.float32 or 0 in rows.shape:
        raise ValueError(f"rows must be fp32 [B, V], got {rows.dtype} {tuple(rows.shape)}")
    b = rows.shape[0]
    if keys.dtype != torch.uint32 or keys.shape != (b, 2) or not keys.is_contiguous():
        raise ValueError(f"keys must be contiguous uint32 [{b}, 2], got {keys.dtype} {tuple(keys.shape)}")
    if good.dtype != torch.bool or good.shape != (b,) or not good.is_contiguous():
        raise ValueError(f"good must be a contiguous bool [{b}], got {good.dtype} {tuple(good.shape)}")
    if {keys.device, good.device} != {rows.device}:
        raise ValueError(f"rows, keys and good on {rows.device}, {keys.device}, {good.device}")
    if not temperature > 0.0:
        raise ValueError(f"temperature {temperature}: sampling needs a positive temperature")


def sample_tokens_ref(rows: torch.Tensor, keys: torch.Tensor, temperature: float, good: torch.Tensor,
                      pad_id: int = 0, *, reciprocal: bool = False) -> torch.Tensor:
    """The plain version of :func:`sample_tokens` (any device): int64 tokens
    ``[B]``; ``keys`` advanced in place on the good rows."""
    _check(rows, keys, temperature, good)
    nxt, sub = prng.split(keys).unbind(1)
    if reciprocal:  # a tensor operand: CUDA's kernels would turn a Python divisor into a reciprocal
        scaled = rows * torch.tensor(reciprocal_of(temperature), dtype=torch.float32, device=rows.device)
    else:
        scaled = rows / torch.tensor(temperature, dtype=torch.float32, device=rows.device)
    tok = torch.where(good, prng.categorical(sub, scaled), pad_id)
    keys.copy_(torch.where(good[:, None], nxt.to(torch.int64), keys.to(torch.int64)).to(torch.uint32))
    return tok


def sample_tokens(rows: torch.Tensor, keys: torch.Tensor, temperature: float, good: torch.Tensor,
                  pad_id: int = 0, *, reciprocal: bool = False) -> torch.Tensor:
    """One token a slot row of fp32 ``rows [B, V]`` drawn as JAX draws it
    from the slot's key ``keys [b]`` (uint32 ``[B, 2]``, advanced in place
    where ``good``); ``pad_id`` where ``good`` is clear.  int64 ``[B]``."""
    if not block_mask.on_card(rows):
        return sample_tokens_ref(rows, keys, temperature, good, pad_id, reciprocal=reciprocal)
    from repro_torch.kernels import _build
    from repro_torch.kernels.tensordash_spmm import _arrivals

    _check(rows, keys, temperature, good)
    b, v = rows.shape
    if b > 65535 or v > MAX_V:
        raise ValueError(f"rows [{b}, {v}]: the sampler takes at most 65535 rows of at most {MAX_V}")
    dev = rows.device
    tokens = torch.empty(b, dtype=torch.int64, device=dev)  # every entry written
    stream, current = block_mask._card_stream(dev)
    ws = _arrivals(dev, stream, 3 * b)  # b 64-bit maxima, then b arrival counters
    args = _build.SampleArgs(
        rows=rows.data_ptr(), row_stride=rows.stride(0), col_stride=rows.stride(1), keys=keys.data_ptr(),
        good=good.data_ptr(), tokens=tokens.data_ptr(), best=ws.data_ptr(), arrived=ws.data_ptr() + 8 * b,
        temperature=float(temperature), inv=reciprocal_of(temperature), reciprocal=int(reciprocal),
        B=b, V=v, pad_id=int(pad_id), chunk=sample_geometry(b, v, block_mask.sm_count(dev))[1])
    lib = _build.library()
    with current:
        rc = lib.td_sample(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"td_sample_kernel: CUDA launch failed with cudaError {rc}")
    LAUNCHES["td_sample_kernel"] += 1
    return tokens
