"""Family dispatch (port of ``repro/models/model.py``): one API over the
dense and MoE families (each with GQA or multi-head latent attention), the
SSM family (Mamba2) and the hybrid family (Mamba2 with a shared attention
block).

    param_specs(cfg)                             -> Spec tree
    forward(params, cfg, batch, probes, taps)    -> logits
    loss_fn(params, cfg, batch, probes, taps)    -> mean next-token NLL
    prefill(params, cfg, batch)                  -> (last logits, caches)
    decode_step(params, cfg, caches, batch, pos) -> (logits, caches)
    init_cache(cfg, batch, max_len, device=...)  -> decode caches
    abstract_cache(cfg, batch, max_len)          -> the same on ``meta``

``decode_step``'s ``pos`` is a scalar or an int ``[B]`` tensor (each batch
slot at its own position); it updates the caches in place.  An MLA config's
caches are :class:`~repro_torch.models.mla.MLACache` latents, decoded in
absorbed form; an SSM config's are one
:class:`~repro_torch.models.ssm.SSMCache` per layer, a hybrid config's a
:class:`~repro_torch.models.hybrid.HybridCache`.  ``probes``/``taps`` (the
training instrumentation) reach only the transformer backbone: the JAX
package's SSM and hybrid forwards ignore them too.

Under a runtime with a mesh (``Runtime(sharding=ShardingPolicy(mesh=...))``)
every family runs sharded: ``params`` holds this rank's shards, the
embedding and the LM head are vocab-parallel, and :func:`loss_fn` takes
the vocab-parallel cross entropy of the rank's logits and returns the
global mean over the batch the data ranks hold together.  The dense and
MoE families (GQA or MLA, with or without a frontend) shard in
:mod:`repro_torch.models.transformer`, the SSM family's Mamba2 layers in
:func:`repro_torch.models.ssm.ssm_call` (tensor parallel by heads), the
hybrid's groups and shared block in :mod:`repro_torch.models.hybrid`.
A model rank's decode caches are :func:`local_cache_config`'s.

A frontend config (``inputs_embeds`` in the batch, and ``positions`` under
M-RoPE) runs on the dense family only; its logits are ``[B, S, K, V]``
under the audio frontend, and :func:`loss_fn` then takes labels ``[B, S,
K]``.  The SSM and hybrid families take no frontend here: no registered
config has one.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Spec
from repro_torch.parallel import sharding as S

__all__ = ["param_specs", "forward", "forward_local", "loss_fn", "prefill", "decode_step", "init_cache",
           "abstract_cache", "cache_splits", "local_cache_config"]

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")
    if cfg.frontend is not None and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.frontend} frontend on the {cfg.family} family is not ported "
            "(no registered config has one)")


def _ssm_backbone_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    layer = lambda: {"ln": Spec((d,), init="ones"), "ssm": ssm_mod.ssm_specs(hyb.ssm_config(cfg))}
    return {
        "embed": Spec((v, d), init="embed", axes=("vocab", "embed")),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": Spec((d,), init="ones"),
        "lm_head": Spec((d, v), axes=("embed", "vocab")),
    }


def _hybrid_backbone_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {"embed": Spec((v, d), init="embed", axes=("vocab", "embed")), "final_norm": Spec((d,), init="ones"),
             "lm_head": Spec((d, v), axes=("embed", "vocab"))}
    specs.update(hyb.hybrid_specs(cfg))
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    _supported(cfg)
    if cfg.family == "ssm":
        return _ssm_backbone_specs(cfg)
    if cfg.family == "hybrid":
        return _hybrid_backbone_specs(cfg)
    return tfm.backbone_specs(cfg)


def _ssm_layers(params, cfg: ModelConfig, h, sh=None):
    """The SSM stack over a full sequence (each layer recomputed in the
    backward with ``cfg.remat`` and grad mode on, as JAX checkpoints its
    scan body)."""
    for i, p in enumerate(params["layers"]):
        spec = None if sh is None else sh.specs["layers"][i]
        body = lambda h, p=p, spec=spec: hyb._ssm_layer(p, cfg, h, sh=sh, spec=spec)[0]
        if cfg.remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
        else:
            h = body(h)
    return h


def forward(params, cfg: ModelConfig, batch, probes=None, taps=None):
    return forward_local(params, cfg, batch, probes=probes, taps=taps, local=False)


def forward_local(params, cfg: ModelConfig, batch, probes=None, taps=None, *, local: bool = True):
    """:func:`forward`; on a mesh with ``local``, ``(this rank's logits,
    the first vocab id of its slice)``, as
    :func:`repro_torch.models.transformer.forward_local`."""
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.forward_local(params, cfg, batch, probes=probes, taps=taps, local=local)
    sh = tfm.shards_of(cfg)
    h = tfm._embed_in(params, cfg, batch, sh)
    if cfg.family == "ssm":
        h = _ssm_layers(params, cfg, h, sh)
    else:
        h = hyb.hybrid_forward(params, cfg, h, torch.arange(h.shape[1], device=h.device), sh)
    if sh is None:
        out = tfm._head(params, cfg, h)
        return (out, 0) if local else out
    return tfm._head(params, cfg, h, sh, local=local)


def loss_fn(params, cfg: ModelConfig, batch, probes=None, taps=None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (fp32
    log-softmax; labels ``[B, S, K]`` against the audio frontend's ``[B, S,
    K, V]`` logits, the mean over every codebook's).  ``probes``/``taps``
    are the training instrumentation of
    :func:`repro_torch.models.transformer.forward`."""
    sh = tfm.shards_of(cfg)
    if sh is None:
        logits = forward(params, cfg, batch, probes=probes, taps=taps).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
        return nll.mean()
    # on a mesh: the vocab-parallel cross entropy of this rank's logits
    # (rows [B*S] or, under the audio frontend, [B*S*K]); each data rank's
    # share of the global mean, summed over the data axes (the sum's
    # backward is the identity: each rank differentiates its share)
    logits, start = forward_local(params, cfg, batch, probes=probes, taps=taps)
    logits = logits.float().reshape(-1, logits.shape[-1])
    group = sh.model_group if logits.shape[-1] != cfg.vocab_size else None
    nll = S.vocab_parallel_ce(logits, batch["labels"].reshape(-1), start, group)
    return S.tp_reduce(nll.sum() / (nll.numel() * sh.n_data), sh.data_group)


def prefill(params, cfg: ModelConfig, batch):
    """Forward over the prompt: last-token logits and the filled caches, in
    the activation dtype (``Runtime.grow_caches`` casts them to the decode
    caches' dtypes); on a mesh, this rank's caches
    (:func:`local_cache_config`)."""
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.prefill(params, cfg, batch)
    sh = tfm.shards_of(cfg)
    h = tfm._embed_in(params, cfg, batch, sh)
    if cfg.family == "ssm":
        caches = []
        for i, p in enumerate(params["layers"]):
            h, cache = hyb._ssm_layer(p, cfg, h, sh=sh, spec=None if sh is None else sh.specs["layers"][i],
                                      return_cache=True)
            caches.append(cache)
    else:
        h, caches = hyb.hybrid_prefill(params, cfg, h, torch.arange(h.shape[1], device=h.device), sh)
    return tfm._head(params, cfg, h[:, -1:], sh), caches


def decode_step(params, cfg: ModelConfig, caches, batch, pos, *, seq=None):
    """One decode step; ``seq`` (a :class:`~repro_torch.models.attention.
    SeqSplit`, default the mesh's, :func:`repro_torch.models.transformer.
    seq_split`): the attention caches hold this rank's rows of a
    sequence-split cache."""
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.decode_step(params, cfg, caches, batch, pos, seq=seq)
    sh = tfm.shards_of(cfg)
    h = tfm._embed_in(params, cfg, batch, sh)
    if cfg.family == "ssm":
        for i, (p, c) in enumerate(zip(params["layers"], caches)):
            h, _ = hyb._ssm_layer(p, cfg, h, sh=sh, spec=None if sh is None else sh.specs["layers"][i], cache=c)
    else:
        h, _ = hyb.hybrid_decode(params, cfg, h, caches, pos, sh, seq=seq)
    return tfm._head(params, cfg, h, sh), caches


def cache_splits(cfg: ModelConfig, tp: int) -> frozenset:
    """What a model rank of ``tp`` holds only its own part of in its decode
    caches: ``"kv"``, the kv heads of a head-parallel GQA attention (the
    dense and MoE families', or the hybrid's shared block's: heads and kv
    heads dividing ``tp``); ``"ssm"``, the Mamba2 heads (``conv_x``
    channels and state heads: the heads dividing ``tp``).  An MLA latent,
    the Mamba2 ``conv_b``/``conv_c`` tails and everything of a body that
    runs replicated are held whole."""
    if tp == 1:
        return frozenset()
    if cfg.family == "hybrid":
        heads, kv = cfg.shared_attn_heads, cfg.shared_attn_kv_heads
    else:
        heads, kv = (0, 0) if cfg.use_mla else (cfg.num_heads, cfg.num_kv_heads)
    out = {"kv"} if heads and heads % tp == 0 and kv % tp == 0 else set()
    if cfg.family in ("ssm", "hybrid") and hyb.ssm_config(cfg).num_heads % tp == 0:
        out.add("ssm")
    return frozenset(out)


def local_cache_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config whose :func:`init_cache` gives the decode caches a model
    rank of ``tp`` holds (:func:`cache_splits`)."""
    splits = cache_splits(cfg, tp)
    if cfg.family in ("dense", "moe"):
        return dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // tp) if splits else cfg
    if not splits:
        return cfg
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    if "kv" in splits:
        kw["shared_attn_kv_heads"] = cfg.shared_attn_kv_heads // tp
    return hyb.RankCacheConfig(**kw, ssm_tp=tp if "ssm" in splits else 1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """Zero decode caches allocated on ``device``: bf16 KV rows or MLA
    latents (dense, MoE), one ``SSMCache`` per layer (bf16 conv tails, an
    fp32 state; SSM), a ``HybridCache`` (hybrid)."""
    _supported(cfg)
    if cfg.family == "ssm":
        scfg = hyb.ssm_config(cfg)
        return [ssm_mod.init_ssm_cache(scfg, batch, device=device) for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        return hyb.init_hybrid_cache(cfg, batch, max_len, device=device)
    return tfm.init_layer_caches(cfg, batch, max_len, device=device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """:func:`init_cache` on the ``meta`` device: the decode caches' shapes
    and dtypes, no memory (the dry run's)."""
    return init_cache(cfg, batch, max_len, device="meta")
