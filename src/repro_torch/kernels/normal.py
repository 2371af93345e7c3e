"""The normal fill: ``jax.random.normal`` draws, scaled and cast, written
into a parameter (new: no Pallas counterpart; XLA computes these draws for
the JAX package's ``init_params``, ``repro/models/common.py``).

:func:`fill_normal_` writes into ``out`` (contiguous, bf16 or fp32) the
block of shape ``out.shape`` of ``std * jax.random.normal(key, leaf_shape,
float32)`` that ``offset``, ``full`` and ``starts`` name
(:func:`repro_torch.prng.block_layout`), rounded once to ``out``'s dtype: a
whole leaf, one layer of a stacked leaf or one rank's shard of it, without
drawing the rest.  On a CPU tensor it runs the plain version,
:func:`normal_ref`, built from :mod:`repro_torch.prng`; on a CUDA tensor it
makes one launch of ``td_normal_kernel`` (``csrc/normal.cu``) on the current
stream, with no host read and no allocation.  A failed build or launch
raises.  :data:`LAUNCHES` counts the wrapper calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import block_mask

__all__ = ["fill_normal_", "normal_ref", "merged_dims", "normal_grid", "LAUNCHES", "reset_launch_counts"]

#: calls of ``td_normal_kernel`` since :func:`reset_launch_counts`
LAUNCHES = {"td_normal_kernel": 0}
#: threads a CTA (``kThreads`` in csrc/normal.cu), CTAs a SM of the grid,
#: and the most dims a block may keep after :func:`merged_dims` (``kMaxDims``)
NORMAL_THREADS, NORMAL_CTAS_PER_SM, MAX_DIMS = 256, 8, 6
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    LAUNCHES["td_normal_kernel"] = 0


def merged_dims(shape, strides) -> tuple[tuple, tuple]:
    """The block's dims with those of size 1 dropped and each run of dims
    that is contiguous in the leaf merged into one: ``(shape, strides)``,
    at least one dim (a whole leaf, or a layer of a stack, is one dim of
    stride 1)."""
    dims = [(n, s) for n, s in zip(shape, strides) if n != 1]
    out: list[list[int]] = []
    for n, s in dims:
        if out and out[-1][1] == n * s:
            out[-1] = [out[-1][0] * n, s]
        else:
            out.append([n, s])
    out = out or [[1, 1]]
    return tuple(n for n, _ in out), tuple(s for _, s in out)


def normal_grid(n: int, sms: int) -> int:
    """CTAs of a launch over ``n`` elements on a card of ``sms`` SMs: one
    element a thread up to ``NORMAL_CTAS_PER_SM`` CTAs a SM, then a
    grid-stride loop."""
    return max(1, min(-(-n // NORMAL_THREADS), NORMAL_CTAS_PER_SM * sms))


def normal_ref(key: torch.Tensor, shape, std: float = 1.0, dtype=torch.float32, offset: int = 0, full=None,
               starts=None, device="cpu") -> torch.Tensor:
    """The plain version of :func:`fill_normal_` (any device): the block as
    a new tensor of ``dtype``, ``fp32(std) * normal`` rounded once."""
    x = prng.normal(key.to(device), shape, offset, full, starts)
    return (x * torch.tensor(std, dtype=torch.float32, device=x.device)).to(dtype)


def fill_normal_(out: torch.Tensor, key: torch.Tensor, std: float = 1.0, offset: int = 0, full=None,
                 starts=None) -> torch.Tensor:
    """Write the block of ``std * jax.random.normal(key, leaf, float32)``
    named by ``offset`` / ``full`` / ``starts`` into ``out`` (contiguous,
    bf16 or fp32, the block's shape), rounded once to its dtype; ``key`` a
    uint32 ``[2]`` key on the host.  Returns ``out``."""
    if out.dtype not in _OUT_DTYPES or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous fp32 or bf16 tensor, got {out.dtype}")
    if key.dtype != torch.uint32 or key.shape != (2,) or key.device.type != "cpu":
        raise ValueError(f"key must be uint32 [2] on the host, got {key.dtype} {tuple(key.shape)} on {key.device}")
    shape, strides, first = prng.block_layout(out.shape, offset, full, starts)
    if out.numel() == 0:
        return out
    if not block_mask.on_card(out):
        return out.copy_(normal_ref(key, shape, std, out.dtype, offset, full, starts, out.device))
    from repro_torch.kernels import _build

    dims, dstrides = merged_dims(shape, strides)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"block {shape} keeps {len(dims)} dims; the kernel takes at most {MAX_DIMS}")
    pad = (0,) * (MAX_DIMS - len(dims))
    k0, k1 = key.to(torch.int64).tolist()  # lint: allow-host-sync: the key lies on the host, no device read
    n = out.numel()
    args = _build.NormalArgs(
        out=out.data_ptr(), n=n, offset=first, shape=(ctypes.c_longlong * MAX_DIMS)(*dims, *pad),
        stride=(ctypes.c_longlong * MAX_DIMS)(*dstrides, *pad), k0=k0, k1=k1, scale=float(std),
        ndim=len(dims), out_bf16=int(out.dtype == torch.bfloat16),
        grid=normal_grid(n, block_mask.sm_count(out.device)))
    stream, current = block_mask._card_stream(out.device)
    lib = _build.library()
    with current:
        rc = lib.td_normal(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"td_normal_kernel: CUDA launch failed with cudaError {rc}")
    LAUNCHES["td_normal_kernel"] += 1
    return out
