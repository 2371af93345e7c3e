"""Zamba2-style hybrid backbone (arXiv:2411.15242) in plain torch (port of
``repro/models/hybrid.py``): a stack of Mamba2 blocks with a single
*shared* transformer block invoked once per group of ``attn_every`` SSM
layers.  The shared block sees ``concat(h, h0)`` (current hidden + initial
embedding) through an input projection; its weights are shared across all
invocations, while each invocation keeps its own KV cache.

The JAX version scans over groups with the group weights stacked twice,
``[n_groups, attn_every, ...]``; the port keeps ``params["groups"]`` as a
list of ``n_groups`` lists of ``attn_every`` layer dicts and the caches as
``HybridCache(ssm=[[SSMCache, ...], ...], kv=[KVCache, ...])``.  The JAX
initializer draws a stacked weight with the fan-in of the stacked shape
(``common._fan_in``: every dim but the first and the last), so a group
weight ``[n_groups, attn_every, d, f]`` gets std ``1/sqrt(attn_every·d)``;
the port's per-layer specs carry that std as ``Spec.scale``.

Every product here is a plain ``@`` (the shared MLP too, under a sparse
runtime, as in the JAX version); the LM head is the only planned product of
a hybrid model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ACTIVATIONS, Spec, _fan_in, rms_norm


def ssm_config(cfg: ModelConfig) -> ssm_mod.SSMConfig:
    return ssm_mod.SSMConfig(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_headdim,
        conv_width=cfg.conv_width,
        chunk=cfg.ssm_chunk,
    )


def shared_attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.shared_attn_heads,
        num_kv_heads=cfg.shared_attn_kv_heads,
        head_dim=cfg.d_model // cfg.shared_attn_heads,
        rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk,
    )


def n_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def _stacked_scale(specs, lead: tuple):
    """``specs`` with each ``normal`` leaf's std set to what the JAX
    initializer draws for it stacked as ``[*lead, *shape]``."""
    if isinstance(specs, dict):
        return {k: _stacked_scale(v, lead) for k, v in specs.items()}
    if specs.init == "normal" and specs.scale is None:
        return dataclasses.replace(specs, scale=1.0 / math.sqrt(_fan_in(lead + tuple(specs.shape))))
    return specs


def hybrid_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    lead = (n_groups(cfg), cfg.attn_every)

    def layer():
        return _stacked_scale({"ln": Spec((d,), init="ones"), "ssm": ssm_mod.ssm_specs(ssm_config(cfg))}, lead)

    shared = {
        "norm_in": Spec((2 * d,), init="ones"),
        "w_in": Spec((2 * d, d), axes=(None, "embed")),
        "attn": attn.attention_specs(shared_attn_config(cfg)),
        "norm_mlp": Spec((d,), init="ones"),
        "mlp": {
            "w_gate": Spec((d, cfg.shared_d_ff), axes=("embed", "mlp")),
            "w_up": Spec((d, cfg.shared_d_ff), axes=("embed", "mlp")),
            "w_down": Spec((cfg.shared_d_ff, d), axes=("mlp", "embed")),
        },
    }
    return {"groups": [[layer() for _ in range(cfg.attn_every)] for _ in range(lead[0])], "shared": shared}


class HybridCache(NamedTuple):
    ssm: list  # n_groups lists of attn_every SSMCache
    kv: list  # one KVCache per shared-block invocation


def _shared_mlp(shared, cfg: ModelConfig, h):
    act = ACTIVATIONS[cfg.activation]
    m = rms_norm(h, shared["norm_mlp"])
    m = act(m @ shared["mlp"]["w_gate"]) * (m @ shared["mlp"]["w_up"])
    return m @ shared["mlp"]["w_down"]


def _shared_in(shared, h, h0):
    return rms_norm(torch.cat([h, h0], dim=-1), shared["norm_in"]) @ shared["w_in"]


def _shared_block(shared, cfg: ModelConfig, h, h0, positions, rope, *, return_cache: bool = False):
    """The shared transformer block over a full sequence; ``rope =
    attention.rope_tables(shared_attn_config(cfg), positions)``.  With
    ``return_cache`` also returns this invocation's KV cache."""
    out = attn.attention_fwd(shared["attn"], shared_attn_config(cfg), _shared_in(shared, h, h0),
                             positions, rope, return_cache=return_cache)
    a, cache = out if return_cache else (out, None)
    h = h + a
    h = h + _shared_mlp(shared, cfg, h)
    return (h, cache) if return_cache else h


def _group_fwd(params, group, cfg: ModelConfig, h, h0, positions, rope):
    scfg = ssm_config(cfg)
    h = _shared_block(params["shared"], cfg, h, h0, positions, rope)
    for p in group:
        h = h + ssm_mod.ssm_fwd(p["ssm"], scfg, rms_norm(h, p["ln"]))
    return h


def hybrid_forward(params, cfg: ModelConfig, h, positions):
    """h [B,S,D] -> [B,S,D].  With ``cfg.remat`` and grad mode on, each
    group is recomputed in the backward (the JAX version checkpoints its
    scan body)."""
    h0 = h
    rope = attn.rope_tables(shared_attn_config(cfg), positions)
    for group in params["groups"]:
        body = lambda h, group=group: _group_fwd(params, group, cfg, h, h0, positions, rope)
        if cfg.remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
        else:
            h = body(h)
    return h


def hybrid_prefill(params, cfg: ModelConfig, h, positions):
    """The forward over a prompt, returning ``(h, HybridCache)`` with the
    caches in the activation dtype (``Runtime.grow_caches`` casts them)."""
    h0 = h
    scfg = ssm_config(cfg)
    rope = attn.rope_tables(shared_attn_config(cfg), positions)
    kv, ssm = [], []
    for group in params["groups"]:
        h, cache = _shared_block(params["shared"], cfg, h, h0, positions, rope, return_cache=True)
        kv.append(cache)
        ssm.append([])
        for p in group:
            y, sc = ssm_mod.ssm_fwd(p["ssm"], scfg, rms_norm(h, p["ln"]), return_cache=True)
            h = h + y
            ssm[-1].append(sc)
    return h, HybridCache(ssm=ssm, kv=kv)


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu") -> HybridCache:
    scfg, acfg = ssm_config(cfg), shared_attn_config(cfg)
    return HybridCache(
        ssm=[[ssm_mod.init_ssm_cache(scfg, batch, device=device) for _ in range(cfg.attn_every)]
             for _ in range(n_groups(cfg))],
        kv=[attn.init_cache(acfg, batch, max_len, device=device) for _ in range(n_groups(cfg))],
    )


def hybrid_decode(params, cfg: ModelConfig, h, cache: HybridCache, pos):
    """One-token decode.  h [B,1,D]; ``pos`` a scalar or an int ``[B]``
    tensor.  Every cache of ``cache`` is updated in place; returns ``(h,
    cache)``."""
    h0 = h
    scfg, acfg = ssm_config(cfg), shared_attn_config(cfg)
    shared = params["shared"]
    rope = attn.rope_tables(acfg, attn.decode_positions(pos, h.shape[0], h.device))
    for group, kv, ssm_c in zip(params["groups"], cache.kv, cache.ssm):
        a, _ = attn.attention_decode(shared["attn"], acfg, _shared_in(shared, h, h0), kv, pos, rope)
        h = h + a
        h = h + _shared_mlp(shared, cfg, h)
        for p, c in zip(group, ssm_c):
            y, _ = ssm_mod.ssm_decode(p["ssm"], scfg, rms_norm(h, p["ln"]), c)
            h = h + y
    return h, cache
