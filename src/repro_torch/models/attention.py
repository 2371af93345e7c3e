"""GQA attention with RoPE, qk-norm, logit softcap and sliding windows, a
prefill path that returns the KV cache, and a decode path over a pre-filled
cache with a per-row position (port of ``repro/models/attention.py``).

Scores and softmax are plain tensor ops in the JAX order: fp32 scores, the
``-1e30`` mask, softmax, then a cast to the query dtype.  The KV cache is
bf16 whatever the parameter dtype or, with ``kv_quant``, int8 with an fp32
scale per (token, head).  Decode writes each row's new K/V (and scales)
into the cache tensors in place (the JAX version returns updated copies).

A local layer (``is_global=False`` under a ``sliding_window``) masks the
keys at or before ``q_pos - window``; a global layer takes no window.  The
port's layers run in a Python loop, so the flag is a per-layer Python bool,
where JAX scans it as data (``window = 2**30`` on global layers): the two
give the same mask.

A decode cache whose sequence rows are split over ranks (item 14e, the
dry run's batch-1 ``long_500k`` cells: :class:`SeqSplit`) is attended in
three parts: each rank's scores over its own rows, the max and the sum of
exponentials all-reduced over the group, and each rank's probabilities,
normalised by them, against its own V, whose products one all-reduce sums
(:func:`seq_combine`).

Under M-RoPE (``mrope_sections``, Qwen2-VL) the rotary tables come from
positions ``[B, 3, S]`` (t/h/w streams, :func:`~repro_torch.models.common.
mrope_tables`) and the causal mask from the sequence index ``arange(S)``;
a decode step rotates in text mode, the step's position in all three
streams (:func:`decode_positions` with ``mrope=True``), as JAX's decode
does.  The projections take the input in the dtype JAX promotes it to
against the weights: a frontend's bf16 embeddings meet an fp32 model's
first block in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import (
    Spec, apply_rope, causal_mask, mrope_tables, rms_norm, rotary_embedding, softcap,
)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_softcap: float | None = None
    sliding_window: int | None = None
    mrope_sections: tuple | None = None  # Qwen2-VL M-RoPE: t/h/w frequency slots
    q_chunk: int = 1024
    kv_quant: bool = False  # int8 KV cache with per-(token, head) fp32 scales


def attention_specs(cfg: AttnConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": Spec((d, h * hd), axes=("embed", "heads")),
        "wk": Spec((d, kh * hd), axes=("embed", "kv_heads")),
        "wv": Spec((d, kh * hd), axes=("embed", "kv_heads")),
        "wo": Spec((h * hd, d), axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = Spec((hd,), init="ones")
        specs["k_norm"] = Spec((hd,), init="ones")
    return specs


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, KVH, D] bf16, or int8 when quantized
    v: torch.Tensor  # [B, S, KVH, D]
    k_scale: torch.Tensor | None = None  # [B, S, KVH, 1] fp32 per-row scales
    v_scale: torch.Tensor | None = None


def _kv_quant_rows(x):
    """Per-(token, head) symmetric int8: ``[.., D] -> (int8, fp32 scale)``,
    rounding half to even as ``jnp.round`` does."""
    x = x.float()
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _kv_dequant(q, s, dtype=torch.bfloat16):
    return (q.float() * s).to(dtype)


def rope_tables(cfg: AttnConfig, positions):
    """RoPE ``(cos, sin)`` for positions ``[S]`` or ``[B, S]`` (M-RoPE:
    ``[B, 3, S]``), broadcast over heads.  The layers share them: callers
    build them once per call of the model, not once per layer."""
    if cfg.mrope_sections is not None:
        return mrope_tables(positions, cfg.head_dim, cfg.mrope_sections, cfg.rope_theta)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    return cos[..., None, :], sin[..., None, :]


def _project_qkv(params, cfg: AttnConfig, x, rope):
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # JAX promotes each mixed product on its own, so its backward rounds
    # each product's input cotangent to x's dtype before the three are summed
    up = lambda x, w: x.to(torch.promote_types(x.dtype, w.dtype)) @ w
    q = up(x, params["wq"]).reshape(b, s, h, hd)
    k = up(x, params["wk"]).reshape(b, s, kh, hd)
    v = up(x, params["wv"]).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    cos, sin = rope
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _scores(cfg: AttnConfig, q, k, q_pos, k_pos, window=None):
    """The fp32 scores of ``q [B,T,H,D]`` against ``k [B,S,KVH,D]`` at key
    positions ``k_pos [S]``, softcapped and masked (``-1e30``):
    ``[B, KVH, H/KVH, T, S]``."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, t, kh, h // kh, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * hd ** -0.5
    scores = softcap(scores, cfg.attn_softcap)
    mask = causal_mask(q_pos, k_pos, window)  # [T, S] or [B, T, S]
    if mask.ndim == 2:
        mask = mask[None]
    return torch.where(mask[:, None, None], scores, -1e30)


def _attend(cfg: AttnConfig, q, k, v, q_pos, k_pos, window=None):
    """q [B,T,H,D]; k,v [B,S,KVH,D]; q_pos [T] or [B,T]; k_pos [S].
    A 2-D ``q_pos`` gives every batch row its own causal frontier; a
    ``window`` masks keys at or before ``q_pos - window``.
    Returns [B,T,H,D] in the promoted dtype of the probabilities and ``v``."""
    b, t, h, hd = q.shape
    probs = torch.softmax(_scores(cfg, q, k, q_pos, k_pos, window), dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(dt), v.to(dt))
    return out.reshape(b, t, h, hd)


class SeqSplit(NamedTuple):
    """A decode cache whose sequence rows are split (item 14e): this
    process holds rows ``[rank * S, (rank + 1) * S)`` of the global cache
    (``S`` its local rows), the other ranks of ``group`` (a process group,
    or ``None``: no other rank) the rest.  ``parts`` cuts the local rows
    into that many equal blocks, each taken as one rank's part and combined
    in turn (one card standing in for a group's ranks)."""

    group: Any = None
    rank: int = 0
    parts: int = 1


def _all_reduce(x, op: str, group):
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return x


def seq_combine(scores: list, pv, dtype, group=None):
    """The softmax over row blocks put together: ``scores`` are the blocks'
    fp32 masked scores ``[..., S_j]`` (one rank's rows each), ``pv(j,
    probs)`` block ``j``'s fp32 partial output from its probabilities.  The
    max and the sum of exponentials are taken over the blocks and
    all-reduced over ``group``; each block's probabilities are normalised
    by them and cast to ``dtype`` (the query's, as :func:`_attend` casts
    them), and the partial outputs are summed, then all-reduced.  Only the
    order of the value sum differs from one softmax over every row."""
    gmax = _all_reduce(torch.stack([s.amax(dim=-1, keepdim=True) for s in scores]).amax(dim=0), "max", group)
    exps = [torch.exp(s - gmax) for s in scores]
    gsum = _all_reduce(torch.stack([e.sum(dim=-1, keepdim=True) for e in exps]).sum(dim=0), "sum", group)
    out = torch.stack([pv(j, (e / gsum).to(dtype)) for j, e in enumerate(exps)]).sum(dim=0)
    return _all_reduce(out, "sum", group)


def _blocks(rows: int, parts: int) -> list:
    if rows % parts:
        raise ValueError(f"{rows} cache rows do not cut into {parts} equal parts")
    step = rows // parts
    return [slice(j * step, (j + 1) * step) for j in range(parts)]


def seq_attend(cfg: AttnConfig, q, k, v, q_pos, k_pos, window, seq: SeqSplit):
    """:func:`_attend` over this rank's rows ``k``/``v`` of a cache split by
    ``seq`` (``k_pos``: their global positions), combined with the other
    ranks' by :func:`seq_combine`."""
    b, t, h, hd = q.shape
    blocks = _blocks(k.shape[1], seq.parts)
    scores = [_scores(cfg, q, k[:, r], q_pos, k_pos[r], window) for r in blocks]
    dt = torch.promote_types(q.dtype, v.dtype)
    pv = lambda j, p: torch.einsum("bkgts,bskd->btkgd", p.to(dt).float(), v[:, blocks[j]].to(dt).float())
    return seq_combine(scores, pv, q.dtype, seq.group).to(dt).reshape(b, t, h, hd)


def write_rows(full, new, pos) -> None:
    """Write ``new`` (one row per batch row, ``[B, ...]``) into ``full [B,
    S, ...]`` at sequence position ``pos``: each row at its own (``pos`` an
    int ``[B]`` tensor) or every row at one (a 0-d tensor; an index copy,
    so no host read of ``pos``)."""
    if pos.ndim == 1:
        full[torch.arange(full.shape[0], device=full.device), pos] = new.to(full.dtype)
    else:
        full.index_copy_(1, pos.reshape(1).long(), new[:, None].to(full.dtype))


def owner_write(full, new, pos, offset: int) -> None:
    """:func:`write_rows` into this rank's rows ``full`` of a sequence-split
    cache, whose first global row is ``offset``, only where the global
    ``pos`` falls inside them.  A clamped local index and a blend, no host
    read: it runs on meta tensors and inside a CUDA graph."""
    n = full.shape[1]
    local = pos - offset
    inside = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)
    if idx.ndim == 1:
        old = full[torch.arange(full.shape[0], device=full.device), idx]
    else:
        old = full.index_select(1, idx.reshape(1).long())[:, 0]
    keep = inside.reshape(-1, *([1] * (old.ndim - 1))) if inside.ndim else inside
    write_rows(full, torch.where(keep, new.to(full.dtype), old), idx)


def attend_chunked(cfg: AttnConfig, q, k, v, q_pos, k_pos, window=None):
    """Query-chunked attention: peak score memory B*H*chunk*S."""
    s = q.shape[1]
    c = cfg.q_chunk
    if s <= c or s % c != 0:
        return _attend(cfg, q, k, v, q_pos, k_pos, window)
    outs = [_attend(cfg, q[:, i : i + c], k, v, q_pos[i : i + c], k_pos, window) for i in range(0, s, c)]
    return torch.cat(outs, dim=1)


def _window(cfg: AttnConfig, is_global: bool):
    """The layer's sliding window: none on a global layer."""
    return None if is_global else cfg.sliding_window


def _heads_of(k, v, kv_index):
    """K/V for the query heads a tensor-parallel rank holds: every kv head
    of a replicated cache, picked per local query head by ``kv_index``
    (``None``: the rank holds its own kv heads, grouped as usual)."""
    if kv_index is None:
        return k, v
    return k[:, :, kv_index], v[:, :, kv_index]


def _out_proj(out, wo, dtype, partial: bool):
    """The output projection; ``partial``: a row-parallel rank's fp32
    partial sum, before the sum over the model axis."""
    if partial:
        return out.to(dtype).float() @ wo.float()
    return out.to(dtype) @ wo


def attention_fwd(params, cfg: AttnConfig, x, positions, rope, *, is_global: bool = True,
                  return_cache: bool = False, kv_index=None, partial: bool = False):
    """Training / prefill self-attention over positions ``[S]`` (M-RoPE:
    ``[B, 3, S]``, masked causally by ``arange(S)``); ``rope =
    rope_tables(cfg, positions)``.  With ``kv_quant`` the returned cache is
    int8 with fp32 scales.

    As a tensor-parallel rank's local step, ``cfg`` counts the rank's heads
    and ``params`` holds its columns of ``wq`` (and of ``wk``/``wv``, or all
    of them with ``kv_index`` naming each local query head's kv head) and
    its rows of ``wo``; ``partial`` returns the fp32 partial output."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, rope)
    if positions.ndim != 1:
        positions = torch.arange(s, device=x.device)
    out = attend_chunked(cfg, q, *_heads_of(k, v, kv_index), positions, positions, _window(cfg, is_global))
    y = _out_proj(out.reshape(b, s, -1), params["wo"], q.dtype, partial)
    if not return_cache:
        return y
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = _kv_quant_rows(k), _kv_quant_rows(v)
        return y, KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)
    return y, KVCache(k=k, v=v)


def init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> KVCache:
    """Zero cache: ``dtype`` K/V, or int8 K/V and fp32 ``[.., 1]`` scales
    with ``kv_quant``."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       k_scale=zeros(sshape, torch.float32), v_scale=zeros(sshape, torch.float32))
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))


def decode_positions(pos, b: int, device, *, mrope: bool = False):
    """Query positions of a decode step: ``[B, 1]`` for a per-row ``pos``
    tensor, ``[1]`` for a scalar.  With ``mrope``, the step's M-RoPE
    positions ``[B, 3, 1]`` in text mode: its position (each row's, or the
    scalar for every row) in all three streams, as JAX decodes."""
    pos = torch.as_tensor(pos, device=device)
    if mrope:
        return pos.reshape(-1, 1).expand(b, 1)[:, None, :].expand(b, 3, 1)
    return pos.reshape(b, 1) if pos.ndim == 1 else pos.reshape(1)


def attention_decode(params, cfg: AttnConfig, x, cache: KVCache, pos, rope, *, is_global: bool = True,
                     kv_index=None, partial: bool = False, seq: SeqSplit | None = None):
    """One-token decode.  ``x [B, 1, d]``; ``cache`` is filled up to ``pos``
    (exclusive) and the new token's K/V is written in place at ``pos``
    (with ``kv_quant``: its int8 rows and scales, then the whole cache is
    dequantized to ``x``'s dtype for the step, as JAX does).  ``pos`` is a
    scalar (every row at one position) or an int ``[B]`` tensor (each batch
    slot at its own position); ``rope = rope_tables(cfg,
    decode_positions(pos, B, device, mrope=cfg.mrope_sections is not None))``.
    ``kv_index``/``partial`` as in :func:`attention_fwd`.  With ``seq`` the
    cache holds this rank's rows of a sequence-split cache: the rank that
    owns ``pos`` writes the new row (:func:`owner_write`), and the scores
    over the rank's rows are combined with the other ranks'
    (:func:`seq_attend`).  Returns ``(y, cache)``."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    positions = decode_positions(pos, b, x.device)
    q, k, v = _project_qkv(params, cfg, x, rope)
    offset = 0 if seq is None else seq.rank * s_max

    def write(full, new):
        if seq is None:
            write_rows(full, new[:, 0], pos)
        else:
            owner_write(full, new[:, 0], pos, offset)

    if cfg.kv_quant:
        (kq, ks), (vq, vs) = _kv_quant_rows(k), _kv_quant_rows(v)
        for full, new in zip(cache, (kq, vq, ks, vs)):
            write(full, new)
        k_all = _kv_dequant(cache.k, cache.k_scale, x.dtype)
        v_all = _kv_dequant(cache.v, cache.v_scale, x.dtype)
    else:
        write(cache.k, k)
        write(cache.v, v)
        k_all, v_all = cache.k, cache.v
    k_pos = torch.arange(offset, offset + s_max, device=x.device)
    kv = _heads_of(k_all, v_all, kv_index)
    if seq is None:
        out = _attend(cfg, q, *kv, positions, k_pos, _window(cfg, is_global))
    else:
        out = seq_attend(cfg, q, *kv, positions, k_pos, _window(cfg, is_global), seq)
    dt = torch.promote_types(out.dtype, params["wo"].dtype)
    y = _out_proj(out.reshape(b, 1, -1), params["wo"].to(dt), dt, partial)
    return y, cache
