"""Family dispatch (port of ``repro/models/model.py``): the dense and MoE
families, each with GQA or multi-head latent attention (MLA, deepseek-v2).

    param_specs(cfg)                             -> Spec tree
    forward(params, cfg, batch, probes, taps)    -> logits
    loss_fn(params, cfg, batch, probes, taps)    -> mean next-token NLL
    prefill(params, cfg, batch)                  -> (last logits, caches)
    decode_step(params, cfg, caches, batch, pos) -> (logits, caches)
    init_cache(cfg, batch, max_len, device=...)  -> decode caches

``decode_step``'s ``pos`` is a scalar or an int ``[B]`` tensor (each batch
slot at its own position).  An MLA config's caches are
:class:`~repro_torch.models.mla.MLACache` latents, decoded in absorbed form.  The SSM and hybrid families wait for ROADMAP
queue 1, item 12.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

__all__ = ["param_specs", "forward", "loss_fn", "prefill", "decode_step", "init_cache"]


def _supported(cfg: ModelConfig) -> None:
    """The transformer backbone runs the dense and MoE families, with GQA or
    MLA attention."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported "
                                  "(dense and moe, with GQA or MLA attention, only)")


def param_specs(cfg: ModelConfig) -> dict:
    _supported(cfg)
    return tfm.backbone_specs(cfg)


def forward(params, cfg: ModelConfig, batch, probes=None, taps=None):
    _supported(cfg)
    return tfm.forward(params, cfg, batch, probes=probes, taps=taps)


def loss_fn(params, cfg: ModelConfig, batch, probes=None, taps=None):
    """Mean next-token cross-entropy over ``batch["labels"]`` (fp32
    log-softmax).  ``probes``/``taps`` are the training instrumentation of
    :func:`repro_torch.models.transformer.forward`."""
    logits = forward(params, cfg, batch, probes=probes, taps=taps).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean()


def prefill(params, cfg: ModelConfig, batch):
    _supported(cfg)
    return tfm.prefill(params, cfg, batch)


def decode_step(params, cfg: ModelConfig, caches, batch, pos):
    _supported(cfg)
    return tfm.decode_step(params, cfg, caches, batch, pos)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """Zero decode caches (bf16 KV rows, or bf16 MLA latents), allocated on
    ``device``."""
    _supported(cfg)
    return tfm.init_layer_caches(cfg, batch, max_len, device=device)
