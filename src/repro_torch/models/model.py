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

``decode_step``'s ``pos`` is a scalar or an int ``[B]`` tensor (each batch
slot at its own position); it updates the caches in place.  An MLA config's
caches are :class:`~repro_torch.models.mla.MLACache` latents, decoded in
absorbed form; an SSM config's are one
:class:`~repro_torch.models.ssm.SSMCache` per layer, a hybrid config's a
:class:`~repro_torch.models.hybrid.HybridCache`.  ``probes``/``taps`` (the
training instrumentation) reach only the transformer backbone: the JAX
package's SSM and hybrid forwards ignore them too.

Under a runtime with a mesh (``Runtime(sharding=ShardingPolicy(mesh=...))``)
the dense and MoE families run sharded
(:mod:`repro_torch.models.transformer`): ``params`` holds this rank's
shards, and :func:`loss_fn` takes the vocab-parallel cross entropy of the
rank's logits and returns the global mean over the batch the data ranks
hold together.  The SSM and hybrid families (and MLA and the frontends)
refuse a mesh of more than one rank (ROADMAP queue 1, item 14c).

A frontend config (``inputs_embeds`` in the batch, and ``positions`` under
M-RoPE) runs on the dense family only; its logits are ``[B, S, K, V]``
under the audio frontend, and :func:`loss_fn` then takes labels ``[B, S,
K]``.  The SSM and hybrid families take no frontend here: no registered
config has one.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm as ssm_mod
from repro_torch import runtime as rtm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Spec, rms_norm
from repro_torch.parallel import sharding as S

__all__ = ["param_specs", "forward", "loss_fn", "prefill", "decode_step", "init_cache"]

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")
    if cfg.frontend is not None and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.frontend} frontend on the {cfg.family} family is not ported "
            "(no registered config has one)")
    if cfg.family in ("ssm", "hybrid"):
        policy = rtm.resolve().sharding
        if policy is not None and policy.size > 1:
            tfm.check_shardable(cfg, 1)


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


def _ssm_layers(params, cfg: ModelConfig, h):
    """The SSM stack over a full sequence (each layer recomputed in the
    backward with ``cfg.remat`` and grad mode on, as JAX checkpoints its
    scan body)."""
    scfg = hyb.ssm_config(cfg)
    for p in params["layers"]:
        body = lambda h, p=p: h + ssm_mod.ssm_fwd(p["ssm"], scfg, rms_norm(h, p["ln"]))
        if cfg.remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
        else:
            h = body(h)
    return h


def forward(params, cfg: ModelConfig, batch, probes=None, taps=None):
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.forward(params, cfg, batch, probes=probes, taps=taps)
    h = tfm._embed_in(params, cfg, batch)
    if cfg.family == "ssm":
        h = _ssm_layers(params, cfg, h)
    else:
        h = hyb.hybrid_forward(params, cfg, h, torch.arange(h.shape[1], device=h.device))
    return tfm._head(params, cfg, h)


def loss_fn(params, cfg: ModelConfig, batch, probes=None, taps=None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (fp32
    log-softmax; labels ``[B, S, K]`` against the audio frontend's ``[B, S,
    K, V]`` logits, the mean over every codebook's).  ``probes``/``taps``
    are the training instrumentation of
    :func:`repro_torch.models.transformer.forward`."""
    sh = tfm.shards_of(cfg) if cfg.family in ("dense", "moe") else None
    if sh is None:
        logits = forward(params, cfg, batch, probes=probes, taps=taps).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
        return nll.mean()
    # on a mesh: the vocab-parallel cross entropy of this rank's logits; each
    # data rank's share of the global mean, summed over the data axes (the
    # sum's backward is the identity: each rank differentiates its share)
    logits, start = tfm.forward_local(params, cfg, batch, probes=probes, taps=taps)
    logits = logits.float().reshape(-1, logits.shape[-1])
    group = sh.model_group if logits.shape[-1] != cfg.vocab_size else None
    nll = S.vocab_parallel_ce(logits, batch["labels"].reshape(-1), start, group)
    return S.tp_reduce(nll.sum() / (nll.numel() * sh.n_data), sh.data_group)


def prefill(params, cfg: ModelConfig, batch):
    """Forward over the prompt: last-token logits and the filled caches, in
    the activation dtype (``Runtime.grow_caches`` casts them to the decode
    caches' dtypes)."""
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.prefill(params, cfg, batch)
    h = tfm._embed_in(params, cfg, batch)
    if cfg.family == "ssm":
        scfg = hyb.ssm_config(cfg)
        caches = []
        for p in params["layers"]:
            y, cache = ssm_mod.ssm_fwd(p["ssm"], scfg, rms_norm(h, p["ln"]), return_cache=True)
            h = h + y
            caches.append(cache)
    else:
        h, caches = hyb.hybrid_prefill(params, cfg, h, torch.arange(h.shape[1], device=h.device))
    return tfm._head(params, cfg, h[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, caches, batch, pos):
    _supported(cfg)
    if cfg.family in ("dense", "moe"):
        return tfm.decode_step(params, cfg, caches, batch, pos)
    h = tfm._embed_in(params, cfg, batch)
    if cfg.family == "ssm":
        scfg = hyb.ssm_config(cfg)
        for p, c in zip(params["layers"], caches):
            y, _ = ssm_mod.ssm_decode(p["ssm"], scfg, rms_norm(h, p["ln"]), c)
            h = h + y
    else:
        h, _ = hyb.hybrid_decode(params, cfg, h, caches, pos)
    return tfm._head(params, cfg, h), caches


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
