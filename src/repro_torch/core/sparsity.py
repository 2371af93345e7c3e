"""Sparsity measurement and instrumentation (port of
``repro/core/sparsity.py``).

The statistics stay on the tensor's device as fp32 scalars, so a tap costs
no host sync.  Gradient taps use the zero-probe trick: adding a zero tensor
at an activation makes its gradient exactly that point's output gradient
``G_O`` (paper Eq. 2/3).  :func:`apply_probes` places a probe,
:func:`grad_sparsity` differentiates a loss with respect to the probes with
``torch.autograd.grad`` (JAX's ``jax.grad`` over the probe dict);
:func:`repro_torch.models.transformer.forward` places the model's probes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "SparsityStats",
    "measure",
    "merge_stats",
    "block_mask",
    "block_density",
    "lane_streams",
    "apply_probes",
    "grad_sparsity",
]


class SparsityStats(NamedTuple):
    """Zero counts of one tensor family, as fp32 scalars."""

    zeros: torch.Tensor  # number of zero elements
    total: torch.Tensor  # number of elements
    block_zeros: torch.Tensor  # number of all-zero blocks
    block_total: torch.Tensor  # number of blocks

    @property
    def fraction(self):
        return self.zeros / self.total.clamp(min=1.0)

    @property
    def block_fraction(self):
        return self.block_zeros / self.block_total.clamp(min=1.0)


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


def block_density(x: torch.Tensor, block: int = 16, axis: int = -1) -> torch.Tensor:
    """Share of ``block``-wide groups along ``axis`` holding a nonzero (fp32)."""
    return 1.0 - block_mask(x, block=block, axis=axis).float().mean()


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


def merge_stats(stats: list[SparsityStats]) -> SparsityStats:
    """The field-wise sum of several families' statistics."""
    return SparsityStats(
        zeros=sum(s.zeros for s in stats),
        total=sum(s.total for s in stats),
        block_zeros=sum(s.block_zeros for s in stats),
        block_total=sum(s.block_total for s in stats),
    )


def lane_streams(x: torch.Tensor, n_lanes: int = 16) -> torch.Tensor:
    """Reshape a tensor into ``[streams, T, n_lanes]`` PE input streams.

    The reduction (last) dimension becomes the lane-major stream, zero
    padded to a multiple of ``n_lanes``: the channel-major 16-value blocks of
    the paper's tensor layout (§3.4)."""
    pad = (-x.shape[-1]) % n_lanes
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(-1, x.shape[-1] // n_lanes, n_lanes)


# ---------------------------------------------------------------------------
# Gradient taps (zero-probe trick)
# ---------------------------------------------------------------------------


def apply_probes(x: torch.Tensor, probes: dict | None, name: str) -> torch.Tensor:
    """Add a zero probe at a tap point: no change to the value, but the
    gradient with respect to ``probes[name]`` is the cotangent G_O exactly."""
    if probes is not None and name in probes:
        x = x + probes[name]
    return x


def grad_sparsity(loss_fn, params, probes: dict, *args, **kwargs) -> dict:
    """Zero statistics of the gradient arriving at each probe point.

    ``loss_fn(params, probes, *args) -> scalar`` must route ``probes``
    through :func:`apply_probes`.  The probes are leaves of their own (the
    caller's tensors are not modified): ``torch.autograd.grad`` of the loss
    with respect to them is what ``jax.grad`` over the probe dict gives."""
    names = list(probes)
    leaves = {k: probes[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss = loss_fn(params, leaves, *args, **kwargs)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return {k: measure(torch.zeros_like(leaves[k]) if g is None else g) for k, g in zip(names, grads)}
