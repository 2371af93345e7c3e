"""Architecture registry: importing this package registers the ported configs.

Two dense configs are ported, deepseek-7b and qwen3-4b (grouped-query
attention with qk-norm; the train launcher's default ``--arch``), two MoE
configs, qwen3-moe-235b-a22b and deepseek-v2-236b (multi-head latent
attention, shared experts and a dense first layer), the SSM config
mamba2-780m and the hybrid config zamba2-2.7b (Mamba2 layers with a shared
attention block); the JAX package's other four configs wait for their
dense-family features (ROADMAP queue 1, item 12)."""
from repro_torch.configs.base import REGISTRY, ModelConfig, get_config, register
from repro_torch.configs.smoke import reduce_config
from repro_torch.configs import (  # noqa: F401
    deepseek_7b, deepseek_v2_236b, mamba2_780m, qwen3_4b, qwen3_moe_235b, zamba2_2p7b,
)

ALL_ARCHS = sorted(REGISTRY)

__all__ = ["REGISTRY", "ModelConfig", "get_config", "register", "reduce_config", "ALL_ARCHS"]
