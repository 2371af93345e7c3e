"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro/models/mla.py``).

KV activations are down-projected to a ``kv_lora_rank`` latent plus a small
shared RoPE key; the decode cache holds only ``c_kv [B, S, kv_lora]`` and
``k_pe [B, S, rope]`` (bf16).  Training and prefill run the naive
up-projected form (:func:`mla_fwd`); decode runs the absorbed form
(:func:`mla_decode`): ``W_UK`` folded into the query and ``W_UV`` into the
output, so the scores are taken against the latent cache directly.

Scores and softmax are plain tensor ops in the JAX order: fp32 scores, the
``-1e30`` mask, softmax, then a cast to the activation dtype before the
value product.  As in :mod:`repro_torch.models.attention`, the callers build
the RoPE tables once per model call (:func:`rope_tables`, over
``qk_rope_head_dim``) and decode writes the new latent row into the cache
tensors in place at ``pos``, with no host read of ``pos``, so a decode step
can be captured in a CUDA graph.

Head-parallel over a mesh's ``model`` axis, a rank's local step takes a
config counting its ``num_heads / tp`` heads and its whole heads' columns
of ``wq_b``/``wkv_b`` and rows of ``wo`` (``partial``: the fp32 partial
output, summed over ``model`` by the caller); the latents come from
``wq_a``/``wkv_a`` held whole, so every model rank computes, and caches,
the whole latent.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.attention import (
    SeqSplit, _blocks, decode_positions, owner_write, seq_combine, write_rows,
)
from repro_torch.models.common import Spec, apply_rope, causal_mask, rms_norm, rotary_embedding


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4
    q_chunk: int = 1024

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_specs(cfg: MLAConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wq_a": Spec((d, cfg.q_lora_rank), axes=("embed", None)),
        "q_norm": Spec((cfg.q_lora_rank,), init="ones"),
        "wq_b": Spec((cfg.q_lora_rank, h * cfg.qk_head_dim), axes=(None, "heads")),
        "wkv_a": Spec((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), axes=("embed", None)),
        "kv_norm": Spec((cfg.kv_lora_rank,), init="ones"),
        "wkv_b": Spec((cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), axes=(None, "heads")),
        "wo": Spec((h * cfg.v_head_dim, d), axes=("heads", "embed")),
    }


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # [B, S, kv_lora] bf16
    k_pe: torch.Tensor  # [B, S, rope_dim] bf16


def rope_tables(cfg: MLAConfig, positions):
    """RoPE ``(cos, sin)`` over ``qk_rope_head_dim`` for positions ``[S]``
    or ``[B, S]``, broadcast over heads (the shared key gets a unit head
    axis)."""
    cos, sin = rotary_embedding(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return cos[..., None, :], sin[..., None, :]


def _queries(params, cfg: MLAConfig, x, rope):
    """``(q_nope [B,S,H,nope], q_pe [B,S,H,rope])`` through the query
    latent; ``q_pe`` rotated."""
    b, s, _ = x.shape
    q = rms_norm(x @ params["wq_a"], params["q_norm"]) @ params["wq_b"]
    q = q.reshape(b, s, cfg.num_heads, cfg.qk_head_dim)
    q_nope, q_pe = torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_pe, *rope)


def _latent_kv(params, cfg: MLAConfig, x, rope):
    """``(c_kv [B,S,kv_lora], k_pe [B,S,rope])``: the normed latent and the
    rotated shared RoPE key, what the decode cache stores."""
    kv = x @ params["wkv_a"]
    c_kv, k_pe = torch.split(kv, [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"])
    k_pe = apply_rope(k_pe[:, :, None, :], *rope)[:, :, 0]
    return c_kv, k_pe


def _softmax_probs(scores, mask, dtype):
    """Masked fp32 softmax cast to the activation dtype; ``mask``
    broadcasts to ``scores [B, H, T, S]`` after a head axis is added."""
    scores = torch.where(mask[:, None], scores, -1e30)
    return torch.softmax(scores, dim=-1).to(dtype)


def _out_proj(out, wo, partial: bool):
    """``out @ wo``; ``partial``: a row-parallel rank's fp32 partial."""
    return out.float() @ wo.float() if partial else out @ wo


def mla_fwd(params, cfg: MLAConfig, x, positions, rope, *, return_cache: bool = False, partial: bool = False):
    """Training / prefill path (naive up-projected attention) over positions
    ``[S]``; ``rope = rope_tables(cfg, positions)``.  Queries run in
    ``q_chunk`` chunks when ``S`` is a multiple of it, as in the JAX
    package.  With ``return_cache`` also returns ``MLACache(c_kv, k_pe)`` in
    the activation dtype; ``partial`` as in the module docstring."""
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_pe = _queries(params, cfg, x, rope)
    c_kv, k_pe = _latent_kv(params, cfg, x, rope)
    kv = (c_kv @ params["wkv_b"]).reshape(b, s, h, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope, v = torch.split(kv, [cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    scale = cfg.qk_head_dim ** -0.5
    c = cfg.q_chunk
    c = c if (s > c and s % c == 0) else s
    outs = []
    for i in range(0, s, c):
        qn, qp, pi = q_nope[:, i:i + c], q_pe[:, i:i + c], positions[i:i + c]
        scores = (torch.einsum("bthd,bshd->bhts", qn.float(), k_nope.float())
                  + torch.einsum("bthd,bsd->bhts", qp.float(), k_pe.float())) * scale
        probs = _softmax_probs(scores, causal_mask(pi, positions)[None], x.dtype)
        outs.append(torch.einsum("bhts,bshd->bthd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, s, h * cfg.v_head_dim)
    y = _out_proj(out, params["wo"], partial)
    if return_cache:
        return y, MLACache(c_kv=c_kv, k_pe=k_pe)
    return y


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cpu") -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        k_pe=torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
    )


def mla_decode(params, cfg: MLAConfig, x, cache: MLACache, pos, rope, *, partial: bool = False,
               seq: SeqSplit | None = None):
    """Absorbed one-token decode over the latent cache.  ``x [B, 1, d]``;
    ``cache`` is filled up to ``pos`` (exclusive) and the new token's latent
    row is written in place at ``pos``.  ``pos`` is a scalar or an int
    ``[B]`` tensor (each batch slot at its own position); ``rope =
    rope_tables(cfg, decode_positions(pos, B, device))``; ``partial`` as in
    :func:`mla_fwd`.  With ``seq`` the cache holds this rank's rows of a
    sequence-split latent: the owner of ``pos`` writes the new row and the
    ranks' scores are put together by
    :func:`~repro_torch.models.attention.seq_combine`, as in GQA decode.
    Returns ``(y, cache)``."""
    b = x.shape[0]
    h = cfg.num_heads
    s_max = cache.c_kv.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    positions = decode_positions(pos, b, x.device)
    q_nope, q_pe = _queries(params, cfg, x, rope)  # [B,1,H,*]
    c_new, k_new = _latent_kv(params, cfg, x, rope)
    offset = 0 if seq is None else seq.rank * s_max
    for full, new in ((cache.c_kv, c_new), (cache.k_pe, k_new)):
        if seq is None:
            write_rows(full, new[:, 0], pos)
        else:
            owner_write(full, new[:, 0], pos, offset)
    wkv_b = params["wkv_b"].reshape(cfg.kv_lora_rank, h, cfg.qk_nope_head_dim + cfg.v_head_dim)
    w_uk, w_uv = wkv_b[..., :cfg.qk_nope_head_dim], wkv_b[..., cfg.qk_nope_head_dim:]
    # absorb: the query in latent space, q_lat = q_nope @ W_UK^T per head
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope, w_uk)
    scale = cfg.qk_head_dim ** -0.5
    # a bf16 cache against fp32 probabilities computes in fp32, as JAX promotes
    dt = torch.promote_types(x.dtype, cache.c_kv.dtype)

    def scores_of(c_kv, k_pe, k_pos):
        scores = (torch.einsum("bthl,bsl->bhts", q_lat.float(), c_kv.float())
                  + torch.einsum("bthd,bsd->bhts", q_pe.float(), k_pe.float())) * scale
        mask = causal_mask(positions, k_pos)
        return scores, mask if mask.ndim == 3 else mask[None]

    k_pos = torch.arange(offset, offset + s_max, device=x.device)
    if seq is None:
        probs = _softmax_probs(*scores_of(cache.c_kv, cache.k_pe, k_pos), x.dtype)
        ctx_lat = torch.einsum("bhts,bsl->bthl", probs.to(dt), cache.c_kv.to(dt))  # [B,1,H,lora]
    else:
        blocks = _blocks(s_max, seq.parts)
        scores = []
        for r in blocks:
            sc, mask = scores_of(cache.c_kv[:, r], cache.k_pe[:, r], k_pos[r])
            scores.append(torch.where(mask[:, None], sc, -1e30))
        pv = lambda j, p: torch.einsum("bhts,bsl->bthl", p.to(dt).float(), cache.c_kv[:, blocks[j]].to(dt).float())
        ctx_lat = seq_combine(scores, pv, x.dtype, seq.group).to(dt)
    out = torch.einsum("bthl,lhd->bthd", ctx_lat, w_uv.to(dt)).reshape(b, 1, h * cfg.v_head_dim)
    return _out_proj(out, params["wo"].to(dt), partial), cache
