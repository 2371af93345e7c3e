"""Mixture-of-Experts FFN with TensorDash-style structured sparsity (port of
the single-device path of ``repro/models/moe.py``).

The router's top-k one-hot is the paper's Z-vector at expert granularity:
most (expert, token) pairs are ineffectual, and capacity bucketing advances
the effectual ones into each expert's slots.  A slot no token took holds the
all-zero pad row, so under a sparse runtime and a ReLU gate each expert's
``w_down`` product is a planned block-sparse product whose plan skips it.

Dispatch is gather-based and stays on the device: no ``.item()`` and no
host read, so the decode chunk that runs it can be captured as one CUDA
graph.  The expert-parallel path (``_moe_sharded``, the int8 all-to-all)
needs a process group and waits for the distributed slice (ROADMAP queue 1,
item 14); ``a2a_quant`` is carried and unused, as the JAX package's
mesh-less path leaves it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import runtime as rtm
from repro_torch.models.common import ACTIVATIONS, Spec

__all__ = ["MoEConfig", "moe_specs", "moe_ffn", "expert_capacity"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_scale: bool = True  # normalize top-k weights to sum to 1
    a2a_quant: bool = True  # int8 dispatch payloads of the sharded path (not ported)


def moe_specs(cfg: MoEConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    specs = {
        "router": Spec((d, e), init="scaled", scale=0.02, dtype=torch.float32),
        "w_gate": Spec((e, d, f)),
        "w_up": Spec((e, d, f)),
        "w_down": Spec((e, f, d)),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * cfg.d_ff
        specs["shared"] = {"w_gate": Spec((d, fs)), "w_up": Spec((d, fs)), "w_down": Spec((fs, d))}
    return specs


def expert_capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens (``cfg``: a :class:`MoEConfig` or a
    MoE ``ModelConfig``), in Python floats in the JAX package's order."""
    return max(1, int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor))


def _route(cfg: MoEConfig, x2, router_w):
    """x2 [T, d] -> (weights [T, k] fp32, experts [T, k] int64, probs [T, E]).
    ``torch.topk`` returns the larger probability first, as ``lax.top_k``."""
    logits = x2.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_scale:
        top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return top_p, top_e, probs


def _bucket(cfg: MoEConfig, top_e, n_experts: int, capacity: int, t: int):
    """Capacity bucketing: (slot_table [E, C] token-flat-id or the ``T*k``
    sentinel, pos [T, k] slot within its expert, fits [T, k]).  Positions are
    FIFO in token-major order (a cumsum over the one-hot); an assignment past
    its expert's capacity writes the sentinel entry, which is dropped."""
    flat_e = top_e.reshape(-1)  # [T*k]
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[:, None] == experts).long()  # [T*k, E]
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)  # [T*k]
    fits = pos < capacity
    slot = torch.where(fits, flat_e * capacity + pos, n_experts * capacity)
    n = t * cfg.top_k
    table = torch.full((n_experts * capacity + 1,), n, dtype=torch.long, device=flat_e.device)
    table.scatter_(0, slot, torch.arange(n, device=flat_e.device))
    return (table[:-1].reshape(n_experts, capacity), pos.reshape(-1, cfg.top_k),
            fits.reshape(-1, cfg.top_k))


def _expert_ffn(cfg: MoEConfig, xe, w_gate, w_up, w_down, rt=None):
    """xe [E, C, d] -> [E, C, d] (grouped gated FFN)."""
    act = ACTIVATIONS[cfg.activation]
    h = act(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    rt = rtm.resolve(rt)
    if rt.wants_sparse and cfg.activation in ("relu", "squared_relu"):
        # relu-family gates leave exact zeros in h (and an empty slot's pad
        # row is all zero), so each expert's down-projection is a planned
        # block-sparse product.  One call per expert, as in the JAX package:
        # every expert resolves its own tuned cell (capacity C, not E*C, is
        # the bucket a geometry="auto" runtime tunes for)
        return torch.stack([rt.matmul(h[e], w_down[e], op="moe_expert") for e in range(h.shape[0])])
    return torch.bmm(h, w_down)


def _shared_ffn(cfg: MoEConfig, params, x):
    act = ACTIVATIONS[cfg.activation]
    h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def _moe_local(cfg: MoEConfig, params, x2, rt=None):
    """All experts on one device.  x2 [T, d] -> [T, d]."""
    t = x2.shape[0]
    e = cfg.num_experts
    cap = expert_capacity(cfg, t)
    top_p, top_e, _ = _route(cfg, x2, params["router"])
    table, pos, fits = _bucket(cfg, top_e, e, cap, t)
    pad = x2.new_zeros((1, x2.shape[1]))
    x_pad = torch.cat([x2, pad], 0)
    token_of = torch.clamp_max(table // cfg.top_k, t)  # sentinel -> pad row
    xe = x_pad[token_of]  # [E, C, d]
    ye = _expert_ffn(cfg, xe, params["w_gate"], params["w_up"], params["w_down"], rt=rt)
    ye_flat = torch.cat([ye.reshape(e * cap, -1), ye.new_zeros((1, ye.shape[-1]))], 0)
    slot = torch.where(fits, top_e * cap + pos, e * cap)  # [T, k]
    return torch.einsum("tkd,tk->td", ye_flat[slot], top_p.to(ye.dtype))


def moe_ffn(params, cfg: MoEConfig, x, rt=None):
    """MoE FFN, mesh-less.  x [B, S, d] -> [B, S, d]; ``rt`` as in
    :func:`repro_torch.models.transformer.mlp_fwd`."""
    b, s, d = x.shape
    shared = _shared_ffn(cfg, params["shared"], x) if cfg.num_shared_experts else 0.0
    y = _moe_local(cfg, {k: v for k, v in params.items() if k != "shared"}, x.reshape(-1, d), rt=rt)
    return y.reshape(b, s, d) + shared
