"""Architecture registry: importing this package registers the ported configs.

Only deepseek-7b is ported; the JAX package's other nine configs wait for
their model families (ROADMAP queue 1, item 12)."""
from repro_torch.configs.base import REGISTRY, ModelConfig, get_config, register
from repro_torch.configs.smoke import reduce_config
from repro_torch.configs import deepseek_7b  # noqa: F401

ALL_ARCHS = sorted(REGISTRY)

__all__ = ["REGISTRY", "ModelConfig", "get_config", "register", "reduce_config", "ALL_ARCHS"]
