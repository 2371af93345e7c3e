"""Architecture registry: importing this package registers the ported configs.

Two dense configs are ported, deepseek-7b and qwen3-4b (grouped-query
attention with qk-norm; the train launcher's default ``--arch``), and two
MoE configs, qwen3-moe-235b-a22b and deepseek-v2-236b (multi-head latent
attention, shared experts and a dense first layer); the JAX package's other
six configs wait for their model families and features (ROADMAP queue 1,
item 12)."""
from repro_torch.configs.base import REGISTRY, ModelConfig, get_config, register
from repro_torch.configs.smoke import reduce_config
from repro_torch.configs import deepseek_7b, deepseek_v2_236b, qwen3_4b, qwen3_moe_235b  # noqa: F401

ALL_ARCHS = sorted(REGISTRY)

__all__ = ["REGISTRY", "ModelConfig", "get_config", "register", "reduce_config", "ALL_ARCHS"]
