"""Architecture registry: importing this package registers the ported configs.

Four dense configs are ported: deepseek-7b, qwen3-4b (grouped-query
attention with qk-norm; the train launcher's default ``--arch``),
starcoder2-3b (a non-gated tanh-GELU FFN) and gemma2-2b (local/global
sliding-window attention, sandwich norms, logit softcaps); two MoE configs,
qwen3-moe-235b-a22b and deepseek-v2-236b (multi-head latent attention,
shared experts and a dense first layer); the SSM config mamba2-780m and the
hybrid config zamba2-2.7b (Mamba2 layers with a shared attention block);
and the two frontend configs, qwen2-vl-72b (M-RoPE over precomputed
image-and-text embeddings) and musicgen-large (precomputed audio frame
embeddings, one LM head per codebook).  Every config of the JAX package is
registered."""
from repro_torch.configs.base import (
    REGISTRY, SHAPES, InputShape, ModelConfig, cells, get_config, input_specs, register,
)
from repro_torch.configs.smoke import reduce_config
from repro_torch.configs import (  # noqa: F401
    deepseek_7b, deepseek_v2_236b, gemma2_2b, mamba2_780m, musicgen_large, qwen2_vl_72b, qwen3_4b,
    qwen3_moe_235b, starcoder2_3b, zamba2_2p7b,
)

ALL_ARCHS = sorted(REGISTRY)

__all__ = ["REGISTRY", "SHAPES", "InputShape", "ModelConfig", "cells", "get_config", "input_specs", "register",
           "reduce_config", "ALL_ARCHS"]
