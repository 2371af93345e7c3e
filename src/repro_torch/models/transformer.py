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

__all__ = [
    "attn_config",
    "mla_config",
    "moe_config",
    "block_specs",
    "backbone_specs",
    "mlp_fwd",
    "head_matmul",
    "forward",
    "prefill",
    "decode_step",
    "init_layer_caches",
]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported (dense and moe only)")


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


def mlp_fwd(params, cfg: ModelConfig, x, rt=None, taps: dict | None = None):
    """The FFN; ``taps`` (a dict) receives the hidden activation's
    :class:`~repro_torch.core.sparsity.SparsityStats` as ``"ffn_act"``."""
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
            return rt.matmul(h2, params["w_down"], plan=plan_h).reshape(*lead, -1)
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = act(x @ params["w_up"])
    if taps is not None:
        taps["ffn_act"] = sps.measure(h)
    return h @ params["w_down"]


def head_matmul(cfg: ModelConfig, h, lm_head):
    """``h @ lm_head`` through the active runtime.  Under a sparse runtime
    the weight-side plan is keyed by ``id(lm_head)`` and built once; every
    later call with the same tensor object replays it from the plan cache."""
    del cfg
    rt = rtm.resolve()
    b, s, d = h.shape
    if rt.wants_sparse:
        out = rt.matmul(h.reshape(b * s, d), lm_head, plan_key=("lm_head", id(lm_head)), side="B")
        return out.reshape(b, s, -1)
    return h @ lm_head


def _embed_in(params, cfg: ModelConfig, batch):
    """The first hidden state: a frontend's ``inputs_embeds`` cast to bf16
    (as JAX casts them, whatever the model's dtype), else the token
    embedding by gather (equal to the JAX decode path's one-hot matmul: one
    nonzero term per row)."""
    if cfg.frontend is not None:
        h = batch["inputs_embeds"].to(torch.bfloat16)
    else:
        h = params["embed"][batch["tokens"].long()]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype)
    return h


def _ffn(p, cfg: ModelConfig, x, rt=None, taps: dict | None = None):
    """The block's FFN: the MoE FFN where its MLP has a router, whose taps
    measure the MoE output (there is no hidden activation to tap inside the
    expert dispatch), else :func:`mlp_fwd`."""
    if cfg.num_experts and "router" in p:
        m = moe_mod.moe_ffn(p, moe_config(cfg), x, rt=rt)
        if taps is not None:
            taps["ffn_act"] = sps.measure(m)
        return m
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


def _block_fwd(p, cfg: ModelConfig, h, positions, rope, i: int, *, return_cache: bool = False,
               probe=None, taps: dict | None = None, rt=None):
    """Block ``i`` of its stack.  ``probe`` (a zero tensor) is added at the
    MLP output, so its gradient is this layer's G stream; ``taps`` as in
    :func:`_ffn`."""
    acfg, _, fwd, _ = _attention(cfg)
    zc = cfg.post_norms  # gemma-style (1 + w) norms
    out = fwd(p["attn"], acfg, rms_norm(h, p["ln1"], zero_centered=zc), positions, rope,
              return_cache=return_cache, **_layer_kw(cfg, i))
    a, cache = out if return_cache else (out, None)
    h = h + _post_norm(p, "post_attn_norm", cfg, a)
    m = _ffn(p["mlp"], cfg, rms_norm(h, p["ln2"], zero_centered=zc), rt=rt, taps=taps)
    m = _post_norm(p, "post_mlp_norm", cfg, m)
    if probe is not None:  # cast, so the add never promotes a bf16 activation
        m = m + probe.to(m.dtype)
    return h + m, cache


def _head(params, cfg: ModelConfig, h):
    """Final norm and LM head: logits ``[B, S, v]``, or ``[B, S, K, v]``
    from the audio frontend's ``K`` codebook heads (a plain einsum, as JAX
    computes them)."""
    h = rms_norm(h, params["final_norm"], zero_centered=cfg.post_norms)
    if cfg.frontend == "audio":
        logits = torch.einsum("bsd,kdv->bskv", h, params["lm_head"])
    else:
        logits = head_matmul(cfg, h, params["lm_head"])
    return softcap(logits, cfg.final_softcap)


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
    check_supported(cfg)
    rt = rtm.resolve()
    h = _embed_in(params, cfg, batch)
    positions = _positions(cfg, batch, h.shape[1], h.device)
    rope = _rope(cfg, positions)
    for stack in _stacks(params):
        stack_probes = (probes or {}).get(stack)
        stats = []
        for i, p in enumerate(params[stack]):
            t = {} if taps is not None else None
            pr = None if stack_probes is None else stack_probes[i]
            body = lambda h, pr, p=p, i=i, t=t: _block_fwd(p, cfg, h, positions, rope, i, probe=pr, taps=t,
                                                           rt=rt)[0]
            if cfg.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(body, h, pr, use_reentrant=False)
            else:
                h = body(h, pr)
            stats.append(t)
        if taps is not None:
            taps[stack] = {"ffn_act": sps.SparsityStats(*map(torch.stack, zip(*(t["ffn_act"] for t in stats))))}
    return _head(params, cfg, h)


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


def decode_step(params, cfg: ModelConfig, caches, batch, pos):
    """One-token decode against pre-filled caches; returns ``(logits,
    caches)`` with the caches updated in place."""
    check_supported(cfg)
    h = _embed_in(params, cfg, batch)
    acfg, tables, _, decode = _attention(cfg)
    rope = tables(acfg, attn.decode_positions(pos, h.shape[0], h.device, mrope=cfg.mrope_sections is not None))
    zc = cfg.post_norms
    for stack in _stacks(params):
        for i, (p, cache) in enumerate(zip(params[stack], caches[stack])):
            a, _ = decode(p["attn"], acfg, rms_norm(h, p["ln1"], zero_centered=zc), cache, pos, rope,
                          **_layer_kw(cfg, i))
            h = h + _post_norm(p, "post_attn_norm", cfg, a)
            m = _ffn(p["mlp"], cfg, rms_norm(h, p["ln2"], zero_centered=zc))
            h = h + _post_norm(p, "post_mlp_norm", cfg, m)
    return _head(params, cfg, h), caches


def prefill(params, cfg: ModelConfig, batch):
    """Forward over the prompt: last-token logits and the filled KV caches
    (``MLACache(c_kv, k_pe)`` latents with ``use_mla``; in the activation
    dtype, or int8 with fp32 scales under ``kv_cache_quant``:
    ``Runtime.grow_caches`` casts them to the decode caches' dtypes)."""
    check_supported(cfg)
    h = _embed_in(params, cfg, batch)
    positions = _positions(cfg, batch, h.shape[1], h.device)
    rope = _rope(cfg, positions)
    caches: dict[str, Any] = {}
    for stack in _stacks(params):
        caches[stack] = []
        for i, p in enumerate(params[stack]):
            h, cache = _block_fwd(p, cfg, h, positions, rope, i, return_cache=True)
            caches[stack].append(cache)
    return _head(params, cfg, h[:, -1:]), caches
