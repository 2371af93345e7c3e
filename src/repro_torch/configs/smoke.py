"""Reduced same-family configs for CPU tests (port of ``repro/configs/smoke.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        vocab_size=256,
        d_ff=128 if cfg.d_ff else 0,
        q_chunk=32,
        remat=False,
    )
    if cfg.family in ("dense", "moe"):
        kw.update(
            num_layers=2 + cfg.first_dense_layers,
            num_heads=4,
            num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
            head_dim=16,
        )
        if cfg.sliding_window:
            kw["sliding_window"] = 8
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family == "moe":
        kw.update(num_experts=8, top_k=2, moe_d_ff=32)
        if cfg.num_shared_experts:
            kw["num_shared_experts"] = 1
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
        kw["num_layers"] = 4 if cfg.family == "hybrid" else 2
    if cfg.family == "hybrid":
        kw.update(attn_every=2, shared_attn_heads=4, shared_attn_kv_heads=2, shared_d_ff=128)
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 2, 2)
    if cfg.frontend == "audio":
        kw["num_codebooks"] = 2
    return dataclasses.replace(cfg, **kw)
