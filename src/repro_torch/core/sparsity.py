"""Sparsity measurement for the training taps (port of the part of
``repro/core/sparsity.py`` the train step needs: :class:`SparsityStats`,
:func:`measure`, :func:`block_mask`).

The statistics stay on the tensor's device as fp32 scalars, so a tap costs
no host sync.  Gradient taps use the zero-probe trick: adding a zero tensor
at an activation makes its gradient exactly that point's output gradient
``G_O`` (paper Eq. 2/3); :func:`repro_torch.models.transformer.forward`
places the probes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SparsityStats", "measure", "block_mask"]


class SparsityStats(NamedTuple):
    """Zero counts of one tensor family, as fp32 scalars."""

    zeros: torch.Tensor  # number of zero elements
    total: torch.Tensor  # number of elements
    block_zeros: torch.Tensor  # number of all-zero blocks
    block_total: torch.Tensor  # number of blocks


def block_mask(x: torch.Tensor, block: int = 16, axis: int = -1) -> torch.Tensor:
    """True where a ``block``-wide group along ``axis`` is all zero; a
    trailing partial group counts as zero-extended (the 16-value groups of
    paper §3.4)."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % block
    if pad:
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
        x = torch.nn.functional.pad(x, widths)
    xb = x.reshape(x.shape[:axis] + (x.shape[axis] // block, block) + x.shape[axis + 1:])
    return (xb == 0).all(dim=axis + 1)


def measure(x: torch.Tensor, block: int = 16) -> SparsityStats:
    """Element and block zero counts of ``x`` (blocks along its last axis)."""
    x = x.detach()
    bm = block_mask(x, block=block, axis=-1)
    f32 = dict(dtype=torch.float32, device=x.device)
    return SparsityStats(
        zeros=(x == 0).sum(dtype=torch.float32),
        total=torch.full((), float(x.numel()), **f32),
        block_zeros=bm.sum(dtype=torch.float32),
        block_total=torch.full((), float(bm.numel()), **f32),
    )
