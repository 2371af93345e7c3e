"""GQA attention with RoPE, qk-norm and logit softcap, a prefill path that
returns the KV cache, and a decode path over a pre-filled cache with a
per-row position (port of ``repro/models/attention.py``).

Scores and softmax are plain tensor ops in the JAX order: fp32 scores, the
``-1e30`` mask, softmax, then a cast to the query dtype.  The KV cache is
bf16 whatever the parameter dtype.  Decode writes each row's new K/V into
the cache tensors in place (the JAX version returns updated copies).
Sliding windows, M-RoPE and the int8 KV cache are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.common import Spec, apply_rope, causal_mask, rms_norm, rotary_embedding, softcap


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_softcap: float | None = None
    q_chunk: int = 1024


def attention_specs(cfg: AttnConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": Spec((d, h * hd)),
        "wk": Spec((d, kh * hd)),
        "wv": Spec((d, kh * hd)),
        "wo": Spec((h * hd, d)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = Spec((hd,), init="ones")
        specs["k_norm"] = Spec((hd,), init="ones")
    return specs


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, KVH, D] bf16
    v: torch.Tensor  # [B, S, KVH, D] bf16


def rope_tables(cfg: AttnConfig, positions):
    """RoPE ``(cos, sin)`` for positions ``[S]`` or ``[B, S]``, broadcast
    over heads.  The layers share them: callers build them once per call of
    the model, not once per layer."""
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    return cos[..., None, :], sin[..., None, :]


def _project_qkv(params, cfg: AttnConfig, x, rope):
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kh, hd)
    v = (x @ params["wv"]).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    cos, sin = rope
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend(cfg: AttnConfig, q, k, v, q_pos, k_pos):
    """q [B,T,H,D]; k,v [B,S,KVH,D]; q_pos [T] or [B,T]; k_pos [S].
    A 2-D ``q_pos`` gives every batch row its own causal frontier.
    Returns [B,T,H,D] in the promoted dtype of the probabilities and ``v``."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, t, kh, g, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * hd ** -0.5
    scores = softcap(scores, cfg.attn_softcap)
    mask = causal_mask(q_pos, k_pos)  # [T, S] or [B, T, S]
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(dt), v.to(dt))
    return out.reshape(b, t, h, hd)


def attend_chunked(cfg: AttnConfig, q, k, v, q_pos, k_pos):
    """Query-chunked attention: peak score memory B*H*chunk*S."""
    s = q.shape[1]
    c = cfg.q_chunk
    if s <= c or s % c != 0:
        return _attend(cfg, q, k, v, q_pos, k_pos)
    outs = [_attend(cfg, q[:, i : i + c], k, v, q_pos[i : i + c], k_pos) for i in range(0, s, c)]
    return torch.cat(outs, dim=1)


def attention_fwd(params, cfg: AttnConfig, x, positions, rope, *, return_cache: bool = False):
    """Training / prefill self-attention over positions ``[S]``;
    ``rope = rope_tables(cfg, positions)``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, rope)
    out = attend_chunked(cfg, q, k, v, positions, positions)
    y = out.reshape(b, s, -1).to(x.dtype) @ params["wo"]
    if return_cache:
        return y, KVCache(k=k, v=v)
    return y


def init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_positions(pos, b: int, device):
    """Query positions of a decode step: ``[B, 1]`` for a per-row ``pos``
    tensor, ``[1]`` for a scalar."""
    pos = torch.as_tensor(pos, device=device)
    return pos.reshape(b, 1) if pos.ndim == 1 else pos.reshape(1)


def attention_decode(params, cfg: AttnConfig, x, cache: KVCache, pos, rope):
    """One-token decode.  ``x [B, 1, d]``; ``cache`` is filled up to ``pos``
    (exclusive) and the new token's K/V is written in place at ``pos``.
    ``pos`` is a scalar (every row at one position) or an int ``[B]``
    tensor (each batch slot at its own position); ``rope =
    rope_tables(cfg, decode_positions(pos, B, device))``.  Returns ``(y,
    cache)``."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.ndim == 1
    positions = decode_positions(pos, b, x.device)
    q, k, v = _project_qkv(params, cfg, x, rope)
    if per_row:
        rows = torch.arange(b, device=x.device)
        cache.k[rows, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, pos] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    k_pos = torch.arange(s_max, device=x.device)
    out = _attend(cfg, q, cache.k, cache.v, positions, k_pos)
    dt = torch.promote_types(out.dtype, params["wo"].dtype)
    y = out.reshape(b, 1, -1).to(dt) @ params["wo"].to(dt)
    return y, cache
