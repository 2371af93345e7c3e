"""Decoder-only transformer backbone, dense and MoE families, with GQA or
multi-head latent attention (port of ``repro/models/transformer.py``).

Layers run in a Python loop over per-layer parameter dicts in place of the
JAX ``lax.scan``.  Execution policy resolves through
:mod:`repro_torch.runtime`: under a sparse runtime and ``activation ==
"relu"`` the gated FFN takes TensorDash's fused path (the gate matmul applies
ReLU in its store step and emits its output's block mask, which plans the
``w_down`` product without a pass over the values), and the LM head replays
a cached weight-side plan.

Training goes through :func:`forward` with autograd on: every planned
product is then differentiated by :mod:`repro_torch.runtime.autodiff`.
``probes`` adds a zero tensor at each layer's MLP output (its gradient is
that layer's output-gradient stream G, paper Eq. 2/3), ``taps`` collects the
FFN activation's measured sparsity (the A stream), and ``cfg.remat``
recomputes each layer in the backward (``torch.utils.checkpoint``), its
planned kernels included.

A MoE config (``family="moe"``) runs its first ``first_dense_layers``
blocks with the dense FFN (``params["dense_layers"]``) and the rest with
:func:`repro_torch.models.moe.moe_ffn` (``params["layers"]``); a block takes
the MoE branch when its MLP has a ``router``, as in the JAX package.

A config with ``use_mla`` (deepseek-v2) runs :mod:`repro_torch.models.mla`
in place of GQA attention: its RoPE tables span ``qk_rope_head_dim`` and its
decode caches are :class:`~repro_torch.models.mla.MLACache` latents.

Gemma-2's block (``post_norms``) takes zero-centred ``(1 + w)`` norms and
normalizes the attention and FFN outputs again before each residual add
(``post_attn_norm`` / ``post_mlp_norm``); under ``local_global_alternate``
the odd layers of each stack are global and the even ones attend within
``sliding_window``.  ``kv_cache_quant`` keeps the KV cache in int8 with
fp32 scales (:mod:`repro_torch.models.attention`).

Under a runtime whose ``sharding`` policy has a mesh the model is sharded
(:class:`repro_torch.parallel.sharding.ModelShards`): ``params`` holds this
rank's :func:`~repro_torch.parallel.sharding.local_shard` of every leaf
under the policy's ``param_pspecs``, and each layer gathers its weights over
the data axes (FSDP) and runs tensor-parallel over ``model``, a local step
plus one collective: GQA attention column-parallel in its heads (K/V
replicated where the kv heads do not divide the model axis) and
row-parallel in ``wo``; the gated FFN column-parallel in ``w_gate``/``w_up``
(on the fused ReLU path each rank's gate emits the mask of its own columns,
which plans its own ``w_down`` rows) and row-parallel in ``w_down``, whose
fp32 partials are summed; the embedding and the LM head vocab-parallel; the
MoE expert-parallel (:func:`repro_torch.models.moe.moe_ffn_sharded`);
MLA head-parallel (each rank's heads' columns of ``wq_b``/``wkv_b`` and
rows of ``wo``; ``wq_a``/``wkv_a`` and their norms whole on every rank,
which computes and caches the whole latent).  A body whose heads, FFN
width or vocab do not divide the model axis runs replicated over it.  A
frontend's ``inputs_embeds`` (and M-RoPE ``positions``, audio labels) are
cut over the data axes with the batch; the audio head is vocab-parallel on
its last axis.  The SSM and hybrid families shard through
:mod:`repro_torch.models.model` on the same groups.

A frontend config (``frontend``: ``"vision"`` or ``"audio"``, the JAX
package's stubs) has no embedding table: its batch carries precomputed
``inputs_embeds [B, S, d]``, cast to bf16 as JAX casts them.  Under
``mrope_sections`` (qwen2-vl) the batch also carries the t/h/w positions
``[B, 3, S]``; a decode step rotates in text mode.  The audio frontend's
head is one ``[d, v]`` projection per codebook, ``lm_head [K, d, v]``,
giving logits ``[B, S, K, v]``; JAX computes it with a plain einsum outside
its kernels, and so does the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch import runtime as rtm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity as sps
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ACTIVATIONS, Spec, rms_norm, softcap
from repro_torch.parallel import sharding as S

__all__ = [
    "attn_config",
    "mla_config",
    "moe_config",
    "block_specs",
    "backbone_specs",
    "mlp_fwd",
    "head_matmul",
    "forward",
    "forward_local",
    "shards_of",
    "attn_local",
    "prefill",
    "decode_step",
    "init_layer_caches",
]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported (dense and moe only)")


def check_shardable(cfg: ModelConfig, tp: int) -> None:
    """Refuse what this port does not shard over more than one rank: a MoE
    whose experts do not divide the model axis (expert parallelism deals
    whole experts)."""
    if cfg.family == "moe" and cfg.num_experts % tp:
        raise ValueError(f"{cfg.name}: {cfg.num_experts} experts do not divide the model axis ({tp})")


@functools.lru_cache(maxsize=32)
def _model_shards(cfg: ModelConfig, policy, mesh_id: int) -> S.ModelShards:
    """``mesh_id``: the policy's mesh object's ``id``.  Two meshes of one
    layout compare equal, but a mesh made over a later process group holds
    other groups; the entry keeps its mesh alive, so the id is not reused."""
    from repro_torch.models import model as M  # local: model dispatches to this module

    sh = S.ModelShards(policy, policy.param_pspecs(M.param_specs(cfg)))
    if sh.world > 1:
        check_shardable(cfg, sh.tp)
    return sh


def shards_of(cfg: ModelConfig, rt=None) -> "S.ModelShards | None":
    """The sharded model's groups and parameter specs under ``rt``'s (or
    the ambient runtime's) mesh, ``None`` without one."""
    policy = rtm.resolve(rt).sharding
    if policy is None or policy.mesh is None:
        return None
    return _model_shards(cfg, policy, id(policy.mesh))


def attn_local(acfg: attn.AttnConfig, tp: int, rank: int, device=None):
    """``(config, kv_index)`` of model rank ``rank`` of ``tp`` in
    head-parallel attention (``num_heads`` divides ``tp``): the rank's
    ``num_heads / tp`` query heads and its ``num_kv_heads / tp`` kv heads,
    or, where the kv heads do not divide ``tp``, all of them (replicated, as
    JAX's divisibility rule replicates them) with ``kv_index`` naming each
    local query head's kv head."""
    h, kvh = acfg.num_heads, acfg.num_kv_heads
    hl = h // tp
    if kvh % tp == 0:
        return dataclasses.replace(acfg, num_heads=hl, num_kv_heads=kvh // tp), None
    kv_index = torch.div(rank * hl + torch.arange(hl, device=device), h // kvh, rounding_mode="floor")
    return dataclasses.replace(acfg, num_heads=hl), kv_index


def attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        attn_softcap=cfg.attn_softcap,
        sliding_window=cfg.sliding_window,
        mrope_sections=cfg.mrope_sections,
        q_chunk=cfg.q_chunk,
        kv_quant=cfg.kv_cache_quant,
    )


def mla_config(cfg: ModelConfig) -> mla_mod.MLAConfig:
    return mla_mod.MLAConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        kv_lora_rank=cfg.kv_lora_rank,
        q_lora_rank=cfg.q_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk,
    )


def moe_config(cfg: ModelConfig) -> moe_mod.MoEConfig:
    return moe_mod.MoEConfig(
        d_model=cfg.d_model,
        num_experts=cfg.num_experts,
        top_k=cfg.top_k,
        d_ff=cfg.moe_d_ff,
        num_shared_experts=cfg.num_shared_experts,
        capacity_factor=cfg.capacity_factor,
        activation=cfg.activation,
        a2a_quant=cfg.moe_a2a_quant,
    )


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_gated:
        return {"w_gate": Spec((d, f), axes=("embed", "mlp")), "w_up": Spec((d, f), axes=("embed", "mlp")),
                "w_down": Spec((f, d), axes=("mlp", "embed"))}
    return {"w_up": Spec((d, f), axes=("embed", "mlp")), "w_down": Spec((f, d), axes=("mlp", "embed"))}


def block_specs(cfg: ModelConfig, *, moe: bool = False) -> dict:
    d = cfg.d_model
    specs = {
        "ln1": Spec((d,), init="ones"),
        "ln2": Spec((d,), init="ones"),
        "attn": mla_mod.mla_specs(mla_config(cfg)) if cfg.use_mla else attn.attention_specs(attn_config(cfg)),
        "mlp": moe_mod.moe_specs(moe_config(cfg)) if moe else mlp_specs(cfg),
    }
    if cfg.post_norms:
        specs["post_attn_norm"] = Spec((d,), init="ones")
        specs["post_mlp_norm"] = Spec((d,), init="ones")
    return specs


def backbone_specs(cfg: ModelConfig) -> dict:
    """The spec tree; a MoE config's first ``first_dense_layers`` blocks go
    to ``"dense_layers"``, ahead of ``"layers"`` in the forward.  A frontend
    config has no ``"embed"``; the audio frontend's ``"lm_head"`` is
    ``[num_codebooks, d, v]``."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    is_moe = cfg.family == "moe"
    n = cfg.num_layers - cfg.first_dense_layers if is_moe else cfg.num_layers
    specs = {} if cfg.frontend is not None else {"embed": Spec((v, d), init="embed", axes=("vocab", "embed"))}
    specs["layers"] = [block_specs(cfg, moe=is_moe) for _ in range(n)]
    if is_moe and cfg.first_dense_layers:
        specs["dense_layers"] = [block_specs(cfg) for _ in range(cfg.first_dense_layers)]
    specs["final_norm"] = Spec((d,), init="ones")
    specs["lm_head"] = (Spec((cfg.num_codebooks, d, v), axes=(None, "embed", "vocab")) if cfg.frontend == "audio"
                       else Spec((d, v), axes=("embed", "vocab")))
    return specs


def _stacks(params) -> list[str]:
    """The layer stacks of ``params`` in the order the forward runs them."""
    return [k for k in ("dense_layers", "layers") if k in params]


def mlp_fwd(params, cfg: ModelConfig, x, rt=None, taps: dict | None = None, *, partial: bool = False):
    """The FFN; ``taps`` (a dict) receives the hidden activation's
    :class:`~repro_torch.core.sparsity.SparsityStats` as ``"ffn_act"``.

    As a tensor-parallel rank's local step (``params`` its columns of
    ``w_gate``/``w_up`` and rows of ``w_down``), ``partial`` returns the
    fp32 partial output: on the fused path the planned ``w_down`` product
    writes fp32 from its operands (the kernel's bf16-in, fp32-out store),
    planned on the mask the rank's own gate emitted."""
    act = ACTIVATIONS[cfg.activation]
    rt = rtm.resolve(rt)
    if cfg.mlp_gated:
        if rt.wants_sparse and cfg.activation == "relu":
            # fused + emitted-plan path: a block the ReLU gate zeroed stays
            # zero in h (gating is pointwise), so the gate's emitted mask is
            # a valid plan for w_down and h's values are never re-scanned
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1])
            g, gmask = rt.matmul_fused(x2, params["w_gate"], activation="relu", assume_dense=True)
            h2 = g * (x2 @ params["w_up"])
            if taps is not None:
                taps["ffn_act"] = sps.measure(h2.reshape(*lead, -1))
            plan_h = rt.plan_for_fused_output(gmask, h2, params["w_down"])
            out = rt.matmul(h2, params["w_down"], plan=plan_h, out_dtype=torch.float32 if partial else None)
            return out.reshape(*lead, -1)
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = act(x @ params["w_up"])
    if taps is not None:
        taps["ffn_act"] = sps.measure(h)
    if partial:
        return h.float() @ params["w_down"].float()
    return h @ params["w_down"]


def _sum_stats(stats: sps.SparsityStats, sh: S.ModelShards) -> sps.SparsityStats:
    """Tap counts summed over the mesh (a ratio of them is the global one)."""
    return sps.SparsityStats(*S.mesh_all_reduce(torch.stack(tuple(stats)), sh).unbind(0))


def _gathered(p, spec, sh: S.ModelShards) -> dict:
    """A layer's weights gathered over the data axes (FSDP), keys as ``p``."""
    return {k: S.fsdp_gather(v, spec[k], sh) for k, v in p.items()}


def _replicated(w, spec, sh: S.ModelShards) -> dict:
    """Weights gathered over ``model`` too, for a body that runs replicated."""
    return {k: S.gather_model(v, spec[k], sh) for k, v in w.items()}


def _mlp_sharded(p, spec, cfg: ModelConfig, x, sh: S.ModelShards, rt=None, taps: dict | None = None):
    """The dense FFN on a mesh: tensor-parallel where ``mlp`` shards over
    ``model`` (the local step is :func:`mlp_fwd` with ``partial``, then one
    all-reduce of the fp32 partials), else replicated over it."""
    w = _gathered(p, spec, sh)
    if sh.tp == 1 or not sh.is_model(spec["w_up"][1]):
        out = mlp_fwd(_replicated(w, spec, sh), cfg, x, rt=rt, taps=taps)
    else:
        part = mlp_fwd(w, cfg, S.tp_copy(x, sh.model_group), rt=rt, taps=taps, partial=True)
        out = S.tp_reduce(part, sh.model_group).to(torch.promote_types(x.dtype, w["w_down"].dtype))
    if taps is not None:
        taps["ffn_act"] = _sum_stats(taps["ffn_act"], sh)
    return out


def head_matmul(cfg: ModelConfig, h, lm_head, *, key=None, vocab: int | None = None):
    """``h @ lm_head`` through the active runtime.  Under a sparse runtime
    the weight-side plan is keyed by ``key`` (default ``("lm_head",
    id(lm_head))``) and built once; every later call with the same tensor
    object replays it from the plan cache.  ``vocab``: ``lm_head`` is a
    vocab-parallel slice of a head that wide, whose launch the slice's
    splits K as (its logits bit-equal to the whole head's)."""
    del cfg
    rt = rtm.resolve()
    b, s, d = h.shape
    if rt.wants_sparse:
        key = ("lm_head", id(lm_head)) if key is None else key
        whole = (vocab, d, b * s) if vocab is not None and vocab != lm_head.shape[-1] else None
        out = rt.matmul(h.reshape(b * s, d), lm_head, plan_key=key, side="B", split_shape=whole)
        return out.reshape(b, s, -1)
    return h @ lm_head


def _embed_in(params, cfg: ModelConfig, batch, sh: "S.ModelShards | None" = None):
    """The first hidden state: a frontend's ``inputs_embeds`` cast to bf16
    (as JAX casts them, whatever the model's dtype), else the token
    embedding by gather (equal to the JAX decode path's one-hot matmul: one
    nonzero term per row).  On a mesh the lookup is vocab-parallel: each
    model rank gathers the ids inside its slice of the table, zero rows for
    the rest, and one all-reduce sums them."""
    if cfg.frontend is not None:
        h = batch["inputs_embeds"].to(torch.bfloat16)
    elif sh is None:
        h = params["embed"][batch["tokens"].long()]
    else:
        spec = sh.specs["embed"]
        table = S.fsdp_gather(params["embed"], spec, sh)
        ids = batch["tokens"].long()
        if sh.tp > 1 and sh.is_model(spec[0]):
            rows = table.shape[0]
            local = ids - sh.tp_rank * rows
            inside = (local >= 0) & (local < rows)
            h = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
            h = S.tp_reduce(h, sh.model_group)
        else:
            h = S.gather_model(table, spec, sh)[ids]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype)
    return h


def _ffn(p, cfg: ModelConfig, x, rt=None, taps: dict | None = None, *, sh=None, spec=None,
         decode: bool = False):
    """The block's FFN: the MoE FFN where its MLP has a router, whose taps
    measure the MoE output (there is no hidden activation to tap inside the
    expert dispatch), else :func:`mlp_fwd`; on a mesh (``sh``, with the
    layer's ``spec``) their sharded forms.  ``decode`` takes the MoE's
    decode branch."""
    if cfg.num_experts and "router" in p:
        if sh is not None:
            m = moe_mod.moe_ffn_sharded(p, spec, moe_config(cfg), x, sh, rt=rt, seq_sharded=not decode)
        else:
            m = moe_mod.moe_ffn(p, moe_config(cfg), x, rt=rt, seq_sharded=not decode)
        if taps is not None:
            taps["ffn_act"] = sps.measure(m) if sh is None else _sum_stats(sps.measure(m), sh)
        return m
    if sh is not None:
        return _mlp_sharded(p, spec, cfg, x, sh, rt=rt, taps=taps)
    return mlp_fwd(p, cfg, x, rt=rt, taps=taps)


def _attention(cfg: ModelConfig):
    """``(config, rope_tables, fwd, decode)`` of the block's attention, MLA
    or GQA: the two modules' functions take the same arguments.  MLA's RoPE
    spans ``qk_rope_head_dim``, GQA's the head dim."""
    if cfg.use_mla:
        return mla_config(cfg), mla_mod.rope_tables, mla_mod.mla_fwd, mla_mod.mla_decode
    return attn_config(cfg), attn.rope_tables, attn.attention_fwd, attn.attention_decode


def _rope(cfg: ModelConfig, positions):
    """The RoPE tables of one model call, shared by its layers."""
    acfg, tables, _, _ = _attention(cfg)
    return tables(acfg, positions)


def _positions(cfg: ModelConfig, batch, s: int, device):
    """A full-sequence call's positions: the batch's ``[B, 3, S]`` t/h/w
    streams under M-RoPE (required: JAX's M-RoPE prefill fails without
    them too), else ``arange(S)``."""
    if cfg.mrope_sections is None:
        return torch.arange(s, device=device)
    if "positions" not in batch:
        raise ValueError(f"{cfg.name}: M-RoPE needs the batch's positions [B, 3, S] (t/h/w streams)")
    return batch["positions"].to(device)


def _layer_kw(cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s keyword for the attention call: GQA's ``is_global``
    (odd layers of each stack under ``local_global_alternate``, every layer
    otherwise, as JAX's ``_global_flags``); MLA takes none."""
    if cfg.use_mla:
        return {}
    return {"is_global": not cfg.local_global_alternate or i % 2 == 1}


def _post_norm(p, name: str, cfg: ModelConfig, x):
    """Gemma-2's sandwich norm of a sublayer's output (``post_norms``)."""
    return rms_norm(x, p[name], zero_centered=True) if cfg.post_norms else x


def _attn_sharded(p, spec, acfg, sh: S.ModelShards, device):
    """``(weights, config, kv_index, tensor_parallel)`` of this rank's
    attention (``acfg``: GQA or MLA) on a mesh: the layer's weights gathered
    over the data axes, then head-parallel over ``model`` (GQA:
    :func:`attn_local`; replicated K/V gathered whole, their gradients
    summed over ``model``; the qk-norm gains, used on local heads only,
    likewise; MLA: the local heads' config, the latent projections and
    their norms entering whole, their gradient shares summed), or gathered
    over ``model`` too where the heads do not divide it (replicated)."""
    w = _gathered(p, spec, sh)
    if sh.tp == 1 or acfg.num_heads % sh.tp:
        return _replicated(w, spec, sh), acfg, None, False
    g = sh.model_group
    if isinstance(acfg, mla_mod.MLAConfig):
        for k in ("wq_a", "q_norm", "wkv_a", "kv_norm"):
            w[k] = S.tp_copy(w[k], g)
        return w, dataclasses.replace(acfg, num_heads=acfg.num_heads // sh.tp), None, True
    lcfg, kv_index = attn_local(acfg, sh.tp, sh.tp_rank, device)
    if kv_index is not None:
        for k in ("wk", "wv"):
            w[k] = (S.gather_model(w[k], spec[k], sh, grad_sum=True) if sh.is_model(spec[k][1])
                    else S.tp_copy(w[k], g))
    for k in ("q_norm", "k_norm"):
        if k in w:
            w[k] = S.tp_copy(w[k], g)
    return w, lcfg, kv_index, True


def _attention_call(p, cfg: ModelConfig, x, i: int, *, sh=None, spec=None, decode=None, positions=None,
                    rope=None, return_cache: bool = False, acfg=None, seq=None):
    """Block ``i``'s attention over ``x`` (after its norm): the full-sequence
    form, or with ``decode = (cache, pos)`` one decode step (``seq``: over a
    sequence-split cache, :class:`~repro_torch.models.attention.SeqSplit`).
    ``acfg``: a GQA config other than the block's (the hybrid's shared
    block).  On a mesh the head-parallel local step (:func:`_attn_sharded`)
    runs between :func:`~repro_torch.parallel.sharding.tp_copy` and one
    all-reduce of its fp32 partials.  Returns ``(y, cache)``."""
    if acfg is None:
        acfg, _, fwd, dec = _attention(cfg)
    else:
        fwd, dec = attn.attention_fwd, attn.attention_decode
    kw = _layer_kw(cfg, i)
    par = False
    if sh is not None:
        p, acfg, kv_index, par = _attn_sharded(p, spec, acfg, sh, x.device)
        if par:
            dt = torch.promote_types(x.dtype, p["wo"].dtype)
            kw["partial"] = True
            if kv_index is not None:
                kw["kv_index"] = kv_index
            # promoted before the region, as the projections take it: the
            # ranks' gradient shares are then summed before one rounding
            # to a frontend's bf16 input, as one rank's are
            x = S.tp_copy(x.to(dt), sh.model_group)
    if decode is not None:
        if seq is not None:
            kw["seq"] = seq
        y, cache = dec(p, acfg, x, *decode, rope, **kw)
    else:
        out = fwd(p, acfg, x, positions, rope, return_cache=return_cache, **kw)
        y, cache = out if return_cache else (out, None)
    if par:
        y = S.tp_reduce(y, sh.model_group).to(dt)
    return y, cache


def _block_fwd(p, cfg: ModelConfig, h, positions, rope, i: int, *, return_cache: bool = False,
               probe=None, taps: dict | None = None, rt=None, sh=None, spec=None):
    """Block ``i`` of its stack.  ``probe`` (a zero tensor) is added at the
    MLP output, so its gradient is this layer's G stream; ``taps`` as in
    :func:`_ffn`; ``sh``/``spec`` the mesh's groups and the layer's specs."""
    zc = cfg.post_norms  # gemma-style (1 + w) norms
    sub = (lambda k: spec[k]) if spec is not None else (lambda k: None)
    a, cache = _attention_call(p["attn"], cfg, rms_norm(h, p["ln1"], zero_centered=zc), i, sh=sh,
                               spec=sub("attn"), positions=positions, rope=rope, return_cache=return_cache)
    h = h + _post_norm(p, "post_attn_norm", cfg, a)
    m = _ffn(p["mlp"], cfg, rms_norm(h, p["ln2"], zero_centered=zc), rt=rt, taps=taps, sh=sh, spec=sub("mlp"))
    m = _post_norm(p, "post_mlp_norm", cfg, m)
    if probe is not None:  # cast, so the add never promotes a bf16 activation
        m = m + probe.to(m.dtype)
    return h + m, cache


def _head(params, cfg: ModelConfig, h, sh=None, *, local: bool = False):
    """Final norm and LM head: logits ``[B, S, v]``, or ``[B, S, K, v]``
    from the audio frontend's ``K`` codebook heads (a plain einsum, as JAX
    computes them).  On a mesh the head is vocab-parallel: each model rank
    multiplies by its own ``lm_head`` columns (side B, its plan keyed by its
    own shard), and the logits are gathered over ``model`` unless ``local``,
    which returns ``(this rank's logits, the first vocab id of its
    slice)``."""
    h = rms_norm(h, params["final_norm"], zero_centered=cfg.post_norms)
    w, start, vocab_par = params["lm_head"], 0, False
    if sh is not None:
        spec = sh.specs["lm_head"]
        w = S.fsdp_gather(w, spec, sh)
        vocab_par = sh.tp > 1 and sh.is_model(spec[-1])
        if vocab_par:
            h = S.tp_copy(h, sh.model_group)
            start = sh.tp_rank * w.shape[-1]
        else:
            w = S.gather_model(w, spec, sh)
    if cfg.frontend == "audio":
        logits = torch.einsum("bsd,kdv->bskv", h, w)
    else:
        logits = head_matmul(cfg, h, w, key=("lm_head", id(params["lm_head"])), vocab=cfg.vocab_size)
    logits = softcap(logits, cfg.final_softcap)
    if local:
        return logits, start
    return S.tp_gather(logits, logits.ndim - 1, sh.model_group) if vocab_par else logits


def forward(params, cfg: ModelConfig, batch, probes=None, taps=None):
    """Full-sequence forward -> logits ``[B, S, V]`` (``[B, S, K, V]``
    under the audio frontend) (training and eval).

    ``probes`` maps stack names (``"layers"``, and a MoE config's
    ``"dense_layers"``) to zero ``[n_layers, B, S, D]`` tensors added at
    each layer's MLP output: their gradients are the per-layer G_O streams.
    A dict passed as ``taps`` receives, under the same keys, ``{"ffn_act":
    SparsityStats}`` with a leading ``[n_layers]`` axis on each count.
    With ``cfg.remat`` and grad mode on, each layer is recomputed in the
    backward; the runtime is resolved here and passed in, since the
    recompute runs on autograd's thread, outside this call's ambient
    runtime."""
    return forward_local(params, cfg, batch, probes=probes, taps=taps, local=False)


def forward_local(params, cfg: ModelConfig, batch, probes=None, taps=None, *, local: bool = True):
    """:func:`forward`; on a mesh with ``local``, ``(this rank's logits,
    the first vocab id of its slice)`` (the vocab-parallel cross entropy's
    input: the logits are never gathered)."""
    check_supported(cfg)
    rt = rtm.resolve()
    sh = shards_of(cfg, rt)
    h = _embed_in(params, cfg, batch, sh)
    positions = _positions(cfg, batch, h.shape[1], h.device)
    rope = _rope(cfg, positions)
    for stack in _stacks(params):
        stack_probes = (probes or {}).get(stack)
        stats = []
        for i, p in enumerate(params[stack]):
            t = {} if taps is not None else None
            pr = None if stack_probes is None else stack_probes[i]
            spec = sh.specs[stack][i] if sh is not None else None
            body = lambda h, pr, p=p, i=i, t=t, spec=spec: _block_fwd(
                p, cfg, h, positions, rope, i, probe=pr, taps=t, rt=rt, sh=sh, spec=spec)[0]
            if cfg.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(body, h, pr, use_reentrant=False)
            else:
                h = body(h, pr)
            stats.append(t)
        if taps is not None:
            taps[stack] = {"ffn_act": sps.SparsityStats(*map(torch.stack, zip(*(t["ffn_act"] for t in stats))))}
    if sh is None:
        out = _head(params, cfg, h)
        return (out, 0) if local else out
    return _head(params, cfg, h, sh, local=local)


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """Zero decode caches: ``{"layers": [KVCache, ...]}`` (``MLACache`` with
    ``use_mla``), one per layer, and ``"dense_layers"`` for a MoE config's
    dense blocks."""
    n_dense = cfg.first_dense_layers if cfg.family == "moe" else 0

    def one(n):
        if cfg.use_mla:
            return [mla_mod.init_mla_cache(mla_config(cfg), batch, max_len, device=device) for _ in range(n)]
        return [attn.init_cache(attn_config(cfg), batch, max_len, device=device) for _ in range(n)]

    caches = {"layers": one(cfg.num_layers - n_dense)}
    if n_dense:
        caches["dense_layers"] = one(n_dense)
    return caches


def seq_split(sh: "S.ModelShards | None", seq=None):
    """The decode caches' sequence split: ``seq`` where given, else the
    mesh's (its policy's ``seq_axis`` over more than one rank), else
    ``None``."""
    if seq is not None or sh is None or sh.n_seq == 1:
        return seq
    return attn.SeqSplit(group=sh.seq_group, rank=sh.seq_rank)


def decode_step(params, cfg: ModelConfig, caches, batch, pos, *, seq=None):
    """One-token decode against pre-filled caches; returns ``(logits,
    caches)`` with the caches updated in place.  The caches may hold this
    rank's rows of a sequence-split cache (:func:`seq_split`)."""
    check_supported(cfg)
    sh = shards_of(cfg)
    seq = seq_split(sh, seq)
    h = _embed_in(params, cfg, batch, sh)
    acfg, tables, _, _ = _attention(cfg)
    rope = tables(acfg, attn.decode_positions(pos, h.shape[0], h.device, mrope=cfg.mrope_sections is not None))
    zc = cfg.post_norms
    for stack in _stacks(params):
        for i, (p, cache) in enumerate(zip(params[stack], caches[stack])):
            spec = sh.specs[stack][i] if sh is not None else None
            sub = (lambda k: spec[k]) if spec is not None else (lambda k: None)
            a, _ = _attention_call(p["attn"], cfg, rms_norm(h, p["ln1"], zero_centered=zc), i, sh=sh,
                                   spec=sub("attn"), decode=(cache, pos), rope=rope, seq=seq)
            h = h + _post_norm(p, "post_attn_norm", cfg, a)
            m = _ffn(p["mlp"], cfg, rms_norm(h, p["ln2"], zero_centered=zc), sh=sh, spec=sub("mlp"), decode=True)
            h = h + _post_norm(p, "post_mlp_norm", cfg, m)
    return _head(params, cfg, h, sh), caches


def prefill(params, cfg: ModelConfig, batch):
    """Forward over the prompt: last-token logits and the filled KV caches
    (``MLACache(c_kv, k_pe)`` latents with ``use_mla``; in the activation
    dtype, or int8 with fp32 scales under ``kv_cache_quant``:
    ``Runtime.grow_caches`` casts them to the decode caches' dtypes)."""
    check_supported(cfg)
    sh = shards_of(cfg)
    h = _embed_in(params, cfg, batch, sh)
    positions = _positions(cfg, batch, h.shape[1], h.device)
    rope = _rope(cfg, positions)
    caches: dict[str, Any] = {}
    for stack in _stacks(params):
        caches[stack] = []
        for i, p in enumerate(params[stack]):
            spec = sh.specs[stack][i] if sh is not None else None
            h, cache = _block_fwd(p, cfg, h, positions, rope, i, return_cache=True, sh=sh, spec=spec)
            caches[stack].append(cache)
    return _head(params, cfg, h[:, -1:], sh), caches
