"""Parameter specs, seeded init and shared layer primitives (port of
``repro/models/common.py``).

Parameters are plain nested dicts of tensors.  The port keeps one dict per
layer (``params["layers"]`` is a list) where the JAX package stacks layers
along a leading axis for ``lax.scan``; :func:`repro_torch.convert.params_from_jax`
unstacks.  :func:`init_params` draws what the JAX initializer draws: seed
``s`` gives the weights of ``init_params(specs, jax.random.PRNGKey(s))``,
leaf for leaf, each layer cut from its stacked leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import prng
from repro_torch.kernels.normal import fill_normal_

DEFAULT_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor (shape + initializer).  ``scale``
    overrides the initializer's std; ``dtype`` (a torch dtype) overrides the
    tree's dtype for this leaf, as the MoE router stays fp32.  ``axes``
    names each dim's logical axis (or ``None``), the JAX package's names,
    which :func:`repro_torch.parallel.sharding.param_pspecs` maps onto a
    mesh; ``None`` for the whole tuple leaves every dim unnamed."""

    shape: tuple
    init: str = "normal"  # normal | ones | zeros | embed | scaled
    scale: float | None = None
    dtype: Any = None
    axes: tuple | None = None

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not name the {len(self.shape)} dims of {self.shape}")


def _fan_in(shape: tuple) -> int:
    # convention: last dim is the output features; everything else is fan-in,
    # except a leading dim of a rank > 2 weight (the layers of a stacked leaf)
    if len(shape) == 1:
        return shape[0]
    return max(1, math.prod(shape[:-1]) // (shape[0] if len(shape) > 2 else 1))


def leaf_std(spec: Spec, stacked: tuple) -> float:
    """The std JAX's ``init_params`` draws a ``normal``, ``scaled`` or
    ``embed`` leaf at, ``stacked`` the shape it draws (the per-layer shape
    behind the layer axes, ``(L,)`` or ``(G, A)``): the spec's ``scale``
    where it has one, else ``1/sqrt(_fan_in(stacked))``, 0.02 and 1.  A
    stacked ``[L, E, d, f]`` expert leaf divides by ``L`` alone, so each
    expert draws at ``1/sqrt(E * d)``."""
    if spec.init == "embed":
        return 1.0
    if spec.scale is not None:
        return spec.scale
    if spec.init == "normal":
        return 1.0 / math.sqrt(_fan_in(tuple(stacked)))
    if spec.init == "scaled":
        return 0.02
    raise ValueError(spec.init)


def stacked_leaves(specs) -> dict[tuple, tuple[Spec, tuple]]:
    """The leaves of the tree JAX stacks from ``specs``, in JAX's flatten
    order (dict keys sorted): ``{dict-key path: (spec, layer axes)}``.  A
    list is a layer stack (``layers``, ``dense_layers``; a hybrid's
    ``groups``, a list of lists, stacks as ``(G, A)``): its elements must
    hold the same specs, and one stacked leaf holds them all."""
    found: dict[tuple, list] = {}

    def walk(tree, path, lead):
        if isinstance(tree, Spec):
            seen = found.setdefault(path, [tree, lead, 0])
            if seen[:2] != [tree, lead]:
                raise ValueError(f"{'/'.join(path)}: the layers of a stack must hold the same specs")
            seen[2] += 1
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,), lead)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path, lead + (len(tree),))
        else:
            raise TypeError(type(tree))

    walk(specs, (), ())
    for path, (_, lead, count) in found.items():
        if count != math.prod(lead):
            raise ValueError(f"{'/'.join(path)}: {count} specs in a stack of {lead}")
    return {path: tuple(found[path][:2]) for path in sorted(found)}


def init_params(specs, *, seed: int = 0, dtype=DEFAULT_DTYPE, device="cuda", policy=None):
    """Materialize a spec tree on ``device`` as JAX's ``init_params(specs,
    PRNGKey(seed), dtype)`` does, on the tree JAX stacks.

    Each stacked leaf (:func:`stacked_leaves`) gets its key from
    ``split(PRNGKey(seed), n_leaves)`` in JAX's flatten order; ``normal``
    draws at :func:`leaf_std` (the stacked shape's fan-in), ``scaled`` at
    0.02 and ``embed`` at 1, each ``fp32(std) * jax.random.normal`` rounded
    once to the spec's dtype or ``dtype``.  Layer ``l`` of a stack (``(g,
    a)`` of a hybrid's groups) is the stacked leaf's flat range ``[l * n,
    (l + 1) * n)``, drawn by itself.  With a mesh-backed sharding
    ``policy`` only this rank's ``local_shard`` of each tensor under
    ``policy.param_pspecs`` is drawn, so the device never holds a whole
    parameter.  The draws go through :func:`repro_torch.kernels.normal.fill_normal_`:
    the fill kernel on a card, its plain version on the CPU."""
    device = torch.device(device)
    sharded = policy is not None and policy.mesh is not None
    pspecs = policy.param_pspecs(specs) if sharded else None
    leaves = stacked_leaves(specs)
    keys = dict(zip(leaves, prng.split(prng.prng_key(seed), len(leaves))))

    def make(spec: Spec, ps, path, idx):
        dt = spec.dtype or dtype
        shape, starts = spec.shape, (0,) * len(spec.shape)
        if ps is not None:
            from repro_torch.parallel.sharding import rank_index, shard_bounds  # local: sharding is above the models

            shape, starts = shard_bounds(tuple(spec.shape), ps, rank_index(policy))
        if spec.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if spec.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        lead = leaves[path][1]
        layer = sum(i * math.prod(lead[d + 1:]) for d, i in enumerate(idx))
        out = torch.empty(shape, dtype=dt, device=device)
        return fill_normal_(out, keys[path], leaf_std(spec, lead + tuple(spec.shape)),
                            offset=layer * math.prod(spec.shape), full=spec.shape, starts=starts)

    def walk(tree, ps, path, idx):
        if isinstance(tree, Spec):
            return make(tree, ps, path, idx)
        if isinstance(tree, dict):
            return {k: walk(v, None if ps is None else ps[k], path + (k,), idx) for k, v in tree.items()}
        return [walk(v, None if ps is None else ps[i], path, idx + (i,)) for i, v in enumerate(tree)]

    return walk(specs, pspecs, (), ())


def abstract_params(specs, *, dtype=DEFAULT_DTYPE, policy=None):
    """The spec tree as tensors on the ``meta`` device, which hold no
    memory (the dry run's parameters): each leaf in the spec's dtype or
    ``dtype``; with a mesh-backed sharding ``policy`` only this rank's
    ``local_shard`` of it under ``policy.param_pspecs``, by the rule
    :func:`init_params` keeps.  Draws nothing."""
    sharded = policy is not None and policy.mesh is not None
    pspecs = policy.param_pspecs(specs) if sharded else None

    def make(spec: Spec, ps):
        x = torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta")
        if ps is None:
            return x
        from repro_torch.parallel.sharding import local_shard  # local: sharding is above the models

        return torch.empty_like(local_shard(x, ps, policy), memory_format=torch.contiguous_format)

    def walk(tree, ps):
        if isinstance(tree, Spec):
            return make(tree, ps)
        if isinstance(tree, dict):
            return {k: walk(v, None if ps is None else ps[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, None if ps is None else ps[i]) for i, v in enumerate(tree)]
        raise TypeError(type(tree))

    return walk(specs, pspecs)


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6, *, zero_centered: bool = False):
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast back to ``x``'s
    dtype (one fused op in place of the JAX version's seven)."""
    w = weight.float()
    if zero_centered:  # gemma-style (1 + w)
        w = 1.0 + w
    return torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), w, eps).to(x.dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """The tanh approximation, as ``jax.nn.gelu(x, approximate=True)``
    (torch's default is the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


#: ``relu`` is ``maximum(x, 0)``, as the JAX package's: at an exact zero its
#: gradient is 1/2 (ties split), where ``clamp_min`` would pass it whole.
#: Dynamic sparsity makes such zeros: a pruned norm-gain block feeding the
#: only weight rows an expert's gate keeps
ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": lambda x: torch.maximum(x, x.new_zeros(()))}


def rotary_embedding(positions, dim: int, theta: float = 1e4):
    """Standard RoPE tables.  positions [...]; returns cos/sin [..., dim/2]."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponent)  # a Python scalar base: no host-to-device copy
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_tables(positions, dim: int, sections, theta: float = 1e6):
    """Qwen2-VL M-RoPE: positions ``[B, 3, S]`` (t/h/w), ``sections`` sum to
    ``dim/2``.  Returns cos/sin ``[B, S, 1, dim/2]``: frequency slot ``j``
    turns with the stream ``sections`` assigns it (the first ``sections[0]``
    slots with t, the next ``sections[1]`` with h, the rest with w)."""
    if positions.ndim != 3 or positions.shape[1] != 3:
        raise ValueError(f"M-RoPE positions must be [B, 3, S], got {tuple(positions.shape)}")
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to dim/2 = {dim // 2}")
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exponent)
    stream = torch.cat([torch.full((n,), i, dtype=torch.long, device=positions.device)
                        for i, n in enumerate(sections)])  # made on the device: no host copy
    pos = positions.float()[:, stream].transpose(1, 2)  # [B, S, dim/2]: slot j's stream
    angles = pos * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin broadcastable to [..., S, 1, D/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(q_pos, k_pos, window: int | None = None):
    """Boolean [.. Sq, Sk] allowed-attention mask."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m
