"""Int8 error-feedback gradient compression for the cross-pod reduction
(port of ``repro/optim/compress.py``).

The pod-to-pod links are the scarcest bandwidth of a multi-pod mesh, so the
data-parallel gradient sum across ``pod`` can run on int8 values with an
error-feedback residual (the 1-bit/8-bit SGD family, Seide et al. 2014 /
Bernstein et al. 2018) without changing convergence materially; the
within-pod reduction stays full precision.  Each gradient is quantized to
symmetric per-tensor int8 after adding the residual its last rounding left,
and the dequantized values are summed over the ``pod`` axis's process group
with ``torch.distributed.all_reduce``, as the JAX package sums them with
``psum`` under ``shard_map``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["quantize", "dequantize", "ef_compress_grads", "init_residuals"]


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8.  Returns ``(q, scale)``.  The divisor is
    a tensor, so the card divides as JAX does (PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-number divisor)."""
    x = x.float()
    amax = torch.clamp_min(x.abs().max(), 1e-12)
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params):
    """fp32 zeros shaped like every leaf of ``params`` (nested dicts/lists)."""
    from repro_torch.runtime.runtime import tree_map  # local: keep import light

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def ef_compress_grads(grads, residuals, group=None):
    """Error-feedback compressed sum of ``grads`` over ``group`` (the
    ``pod`` axis's process group; ``None`` sums over one rank, so nothing
    moves).  Returns ``(reduced fp32 grads, new residuals)``, trees shaped
    like ``grads``."""
    from repro_torch.runtime.runtime import tree_map  # local: keep import light

    def one(g, r):
        g = g.float() + r
        deq = dequantize(*quantize(g))
        red = deq.clone()
        if group is not None:
            dist.all_reduce(red, group=group)
        return red, g - deq

    pairs = tree_map(one, grads, residuals)  # grads' structure, a (sum, residual) pair a leaf
    return tree_map(lambda _, p: p[0], grads, pairs), tree_map(lambda _, p: p[1], grads, pairs)
