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

On a mesh (``sh``, a :class:`~repro_torch.parallel.sharding.ModelShards`)
the Mamba2 layers are tensor-parallel by heads (:func:`repro_torch.models.
ssm.ssm_call`); the shared block's input norm and projection ``w_in`` are
replicated over ``model`` (``w_in`` FSDP-split over ``data``), its
attention head-parallel (the transformer's local step, each invocation's
KV cache holding the rank's kv heads) and its MLP column-parallel in
``w_gate``/``w_up`` and row-parallel in ``w_down`` (one all-reduce of the
fp32 partials).
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
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ACTIVATIONS, Spec, _fan_in, rms_norm
from repro_torch.parallel import sharding as S


def ssm_config(cfg: ModelConfig) -> ssm_mod.SSMConfig:
    """The Mamba2 layers' config; a model rank's under
    :class:`RankCacheConfig` (its ``ssm_tp``)."""
    return ssm_mod.SSMConfig(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_headdim,
        conv_width=cfg.conv_width,
        chunk=cfg.ssm_chunk,
        tp=cfg.ssm_tp if isinstance(cfg, RankCacheConfig) else 1,
    )


@dataclasses.dataclass(frozen=True)
class RankCacheConfig(ModelConfig):
    """An SSM or hybrid config as one model rank's decode caches see it:
    its Mamba2 conv tails and states hold the heads of one rank of
    ``ssm_tp`` (1: all of them); the hybrid's shared KV caches count the
    rank's kv heads in ``shared_attn_kv_heads``.  Only cache allocation
    reads it (:func:`repro_torch.models.model.local_cache_config`)."""

    ssm_tp: int = 1


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


def shared_mlp_local(w, cfg: ModelConfig, m, *, partial: bool = False):
    """The shared block's gated MLP on its normed input ``m``; as a
    tensor-parallel rank's local step (``w`` its columns of
    ``w_gate``/``w_up`` and rows of ``w_down``), ``partial`` returns the
    fp32 partial output."""
    act = ACTIVATIONS[cfg.activation]
    h = act(m @ w["w_gate"]) * (m @ w["w_up"])
    return h.float() @ w["w_down"].float() if partial else h @ w["w_down"]


def _shared_mlp(shared, cfg: ModelConfig, h, sh=None, spec=None):
    """The shared block's MLP after its norm; on a mesh column-parallel in
    ``w_gate``/``w_up`` and row-parallel in ``w_down`` (one all-reduce)
    where ``shared_d_ff`` divides the model axis, else replicated."""
    m = rms_norm(h, shared["norm_mlp"])
    w = shared["mlp"]
    if sh is not None:
        w = tfm._gathered(w, spec["mlp"], sh)
        if sh.tp > 1 and sh.is_model(spec["mlp"]["w_up"][1]):
            g = sh.model_group
            part = shared_mlp_local(w, cfg, S.tp_copy(m, g), partial=True)
            return S.tp_reduce(part, g).to(torch.promote_types(m.dtype, w["w_down"].dtype))
        w = tfm._replicated(w, spec["mlp"], sh)
    return shared_mlp_local(w, cfg, m)


def _shared_in(shared, h, h0, sh=None, spec=None):
    w_in = shared["w_in"] if sh is None else S.fsdp_gather(shared["w_in"], spec["w_in"], sh)
    return rms_norm(torch.cat([h, h0], dim=-1), shared["norm_in"]) @ w_in


def _shared_attn(shared, cfg: ModelConfig, x, *, sh=None, spec=None, **kw):
    """The shared attention over ``x`` (``kw`` as
    :func:`repro_torch.models.transformer._attention_call` takes them):
    ``(y, cache)``, head-parallel on a mesh."""
    return tfm._attention_call(shared["attn"], cfg, x, 0, sh=sh, spec=None if spec is None else spec["attn"],
                               acfg=shared_attn_config(cfg), **kw)


def _shared_block(shared, cfg: ModelConfig, h, h0, positions, rope, *, return_cache: bool = False,
                  sh=None, spec=None):
    """The shared transformer block over a full sequence; ``rope =
    attention.rope_tables(shared_attn_config(cfg), positions)``.  With
    ``return_cache`` also returns this invocation's KV cache."""
    a, cache = _shared_attn(shared, cfg, _shared_in(shared, h, h0, sh, spec), sh=sh, spec=spec,
                            positions=positions, rope=rope, return_cache=return_cache)
    h = h + a
    h = h + _shared_mlp(shared, cfg, h, sh, spec)
    return (h, cache) if return_cache else h


def _ssm_layer(p, cfg: ModelConfig, h, *, sh=None, spec=None, cache=None, return_cache: bool = False):
    """``h`` plus one Mamba2 layer over its norm; ``(h, cache)``."""
    y, cache = ssm_mod.ssm_call(p["ssm"], ssm_config(cfg), rms_norm(h, p["ln"]), sh=sh,
                                spec=None if spec is None else spec["ssm"], cache=cache, return_cache=return_cache)
    return h + y, cache


def _specs(sh):
    """``(shared block's specs, group specs)`` on a mesh, ``None``s without."""
    return (None, None) if sh is None else (sh.specs["shared"], sh.specs["groups"])


def _group_fwd(params, group, cfg: ModelConfig, h, h0, positions, rope, sh=None, gspec=None):
    sspec, _ = _specs(sh)
    h = _shared_block(params["shared"], cfg, h, h0, positions, rope, sh=sh, spec=sspec)
    for j, p in enumerate(group):
        h, _ = _ssm_layer(p, cfg, h, sh=sh, spec=None if gspec is None else gspec[j])
    return h


def hybrid_forward(params, cfg: ModelConfig, h, positions, sh=None):
    """h [B,S,D] -> [B,S,D].  With ``cfg.remat`` and grad mode on, each
    group is recomputed in the backward (the JAX version checkpoints its
    scan body)."""
    h0 = h
    rope = attn.rope_tables(shared_attn_config(cfg), positions)
    _, gspecs = _specs(sh)
    for gi, group in enumerate(params["groups"]):
        gspec = None if gspecs is None else gspecs[gi]
        body = lambda h, group=group, gspec=gspec: _group_fwd(params, group, cfg, h, h0, positions, rope, sh, gspec)
        if cfg.remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
        else:
            h = body(h)
    return h


def hybrid_prefill(params, cfg: ModelConfig, h, positions, sh=None):
    """The forward over a prompt, returning ``(h, HybridCache)`` with the
    caches in the activation dtype (``Runtime.grow_caches`` casts them)."""
    h0 = h
    rope = attn.rope_tables(shared_attn_config(cfg), positions)
    sspec, gspecs = _specs(sh)
    kv, ssm = [], []
    for gi, group in enumerate(params["groups"]):
        h, cache = _shared_block(params["shared"], cfg, h, h0, positions, rope, return_cache=True, sh=sh,
                                 spec=sspec)
        kv.append(cache)
        ssm.append([])
        for j, p in enumerate(group):
            h, sc = _ssm_layer(p, cfg, h, sh=sh, spec=None if gspecs is None else gspecs[gi][j], return_cache=True)
            ssm[-1].append(sc)
    return h, HybridCache(ssm=ssm, kv=kv)


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu") -> HybridCache:
    scfg, acfg = ssm_config(cfg), shared_attn_config(cfg)
    return HybridCache(
        ssm=[[ssm_mod.init_ssm_cache(scfg, batch, device=device) for _ in range(cfg.attn_every)]
             for _ in range(n_groups(cfg))],
        kv=[attn.init_cache(acfg, batch, max_len, device=device) for _ in range(n_groups(cfg))],
    )


def hybrid_decode(params, cfg: ModelConfig, h, cache: HybridCache, pos, sh=None, seq=None):
    """One-token decode.  h [B,1,D]; ``pos`` a scalar or an int ``[B]``
    tensor.  Every cache of ``cache`` is updated in place; returns ``(h,
    cache)``.  The shared block's KV caches may hold this rank's rows of a
    sequence-split cache (:func:`repro_torch.models.transformer.seq_split`)."""
    h0 = h
    seq = tfm.seq_split(sh, seq)
    shared = params["shared"]
    sspec, gspecs = _specs(sh)
    rope = attn.rope_tables(shared_attn_config(cfg), attn.decode_positions(pos, h.shape[0], h.device))
    for gi, (group, kv, ssm_c) in enumerate(zip(params["groups"], cache.kv, cache.ssm)):
        a, _ = _shared_attn(shared, cfg, _shared_in(shared, h, h0, sh, sspec), sh=sh, spec=sspec,
                            decode=(kv, pos), rope=rope, seq=seq)
        h = h + a
        h = h + _shared_mlp(shared, cfg, h, sh, sspec)
        for j, (p, c) in enumerate(zip(group, ssm_c)):
            h, _ = _ssm_layer(p, cfg, h, sh=sh, spec=None if gspecs is None else gspecs[gi][j], cache=c)
    return h, cache
