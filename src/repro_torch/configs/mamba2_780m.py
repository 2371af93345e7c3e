"""Mamba2-780M: attention-free SSD [arXiv:2405.21060] (port of
``repro/configs/mamba2_780m.py``, field for field)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    sub_quadratic=True,
))
