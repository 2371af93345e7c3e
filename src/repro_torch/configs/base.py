"""ModelConfig, the config registry, the input-shape registry and
``input_specs`` (port of ``repro/configs/base.py``).

``input_specs`` gives the dry run (:mod:`repro_torch.launch.dryrun`) its
abstract inputs: tensors on the ``meta`` device, which hold no memory, where
the JAX package returns ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

REGISTRY: dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # attention variants
    activation: str = "silu"
    mlp_gated: bool = True
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None
    local_global_alternate: bool = False  # gemma2: odd layers global
    post_norms: bool = False  # gemma2 sandwich norms
    embed_scale: bool = False  # gemma: x *= sqrt(d)
    mrope_sections: tuple | None = None  # qwen2-vl
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_a2a_quant: bool = True
    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    # hybrid (zamba2)
    attn_every: int = 0
    shared_attn_heads: int = 0
    shared_attn_kv_heads: int = 0
    shared_d_ff: int = 0
    # modality frontend stub
    frontend: str | None = None  # vision | audio
    num_codebooks: int = 1
    # execution
    q_chunk: int = 1024
    remat: bool = True
    unroll: bool = False
    taps: bool = False
    kv_cache_quant: bool = False
    # capability flags
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def param_count(self) -> int:
        """Parameter count as the JAX package counts it.  For the SSM and
        hybrid families that formula takes ``3·d·d_inner + 2·d·N + d_inner·d``
        a Mamba2 layer, about ``d·d_inner`` more than its tensors hold (they
        have ``in_z``, ``in_x`` and ``out_proj``, plus the small ``in_dt``),
        and is kept so that the counts agree.  Likewise a frontend config
        (``frontend`` set) has no embedding table, yet the formula counts
        ``v·d`` for one; its head term is ``num_codebooks·v·d`` under the
        audio frontend (one ``[d, v]`` head per codebook).  Tensor bytes are
        read from the tensors, never from this count."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        n = v * d  # embed (counted for a frontend config too, as JAX does)
        n += v * d * (self.num_codebooks if self.frontend == "audio" else 1)  # head
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            n += l * (3 * d * di + 2 * d * self.ssm_state + di * d)
            if self.family == "hybrid":
                shd = self.shared_attn_heads * (d // max(self.shared_attn_heads, 1))
                n += 2 * d * d + 4 * d * shd + 3 * d * self.shared_d_ff  # shared block
            return n
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(f"param_count: family {self.family!r} not ported")
        hd = self.resolved_head_dim
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )
        else:
            attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        if self.family == "moe":
            moe_l = l - self.first_dense_layers
            ffn = moe_l * 3 * d * self.moe_d_ff * (self.num_experts + self.num_shared_experts)
            ffn += self.first_dense_layers * 3 * d * self.d_ff
            return n + l * attn + ffn
        per_ffn = (3 if self.mlp_gated else 2) * d * self.d_ff
        return n + l * (attn + per_ffn)

    def active_param_count(self) -> int:
        """Parameters a token activates: of the MoE experts, only its top-k."""
        if self.family != "moe":
            return self.param_count()
        moe_l = self.num_layers - self.first_dense_layers
        per_expert = moe_l * 3 * self.d_model * self.moe_d_ff
        return self.param_count() - per_expert * self.num_experts + per_expert * self.top_k


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populate registry)

    return REGISTRY[name]


def cells(cfg: ModelConfig) -> list[str]:
    """The (arch x shape) cells this config runs (``long_500k`` only for
    sub-quadratic archs)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of one cell, global
    shapes, as the JAX package's.

    ``train``   -> tokens/labels (or a frontend's embeddings) for the train step;
    ``prefill`` -> tokens for ``prefill``;
    ``decode``  -> one new token, the decode caches of ``seq_len`` rows
    (:func:`repro_torch.models.model.abstract_cache`) and a 0-d ``pos``."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    bf16, i32 = torch.bfloat16, torch.int32

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            batch = {"inputs_embeds": meta((b, s, cfg.d_model), bf16), "positions": meta((b, 3, s), i32),
                     "labels": meta((b, s), i32)}
        elif cfg.frontend == "audio":
            batch = {"inputs_embeds": meta((b, s, cfg.d_model), bf16),
                     "labels": meta((b, s, cfg.num_codebooks), i32)}
        else:
            batch = {"tokens": meta((b, s), i32), "labels": meta((b, s), i32)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch

    from repro_torch.models.model import abstract_cache  # local: the models import this module

    if cfg.frontend in ("vision", "audio"):
        step = {"inputs_embeds": meta((b, 1, cfg.d_model), bf16)}
    else:
        step = {"tokens": meta((b, 1), i32)}
    step["cache"] = abstract_cache(cfg, b, s)
    step["pos"] = meta((), i32)
    return step
