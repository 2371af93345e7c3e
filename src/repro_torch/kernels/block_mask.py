"""Block zero-mask (port of ``repro/kernels/block_mask.py``).

:func:`block_zero_mask` maps ``x [M, K]`` to int8 ``[M/bm, K/bk]``, 1 where
a ``bm x bk`` block has any nonzero: the TensorDash front end's Z vector at
block granularity.  On a CUDA tensor it launches ``csrc/block_mask.cu``
(one CTA per block; ``x`` may be a strided view) and counts the launch in
its ``launches`` attribute; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.block_any_nonzero`.  ``plan_blocks`` plans
through it, so every plan built from an operand's values on the card (the
LM head's weight plan, the tuner's operands) runs this kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

__all__ = ["block_zero_mask"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def block_zero_mask(x: torch.Tensor, *, bm: int = 128, bk: int = 512) -> torch.Tensor:
    """``[M, K] -> int8 [M/bm, K/bk]``; 1 where the block has any nonzero."""
    if x.ndim != 2:
        raise ValueError(f"block_zero_mask takes a 2-D operand, got {tuple(x.shape)}")
    m, k = x.shape
    if m % bm or k % bk:
        raise ValueError(f"operand {tuple(x.shape)} not divisible by block ({bm}, {bk})")
    if x.device.type == "cpu":
        return ref.block_any_nonzero(x, bm, bk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_zero_mask kernel takes float32 or bfloat16, got {x.dtype}")
    out = torch.empty((m // bm, k // bk), dtype=torch.int8, device=x.device)
    from repro_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.td_block_zero_mask(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), m, k, bm, bk,
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"block_zero_mask: CUDA launch failed with cudaError {rc}")
    block_zero_mask.launches += 1
    return out


block_zero_mask.launches = 0
