"""Zamba2-2.7B hybrid: a Mamba2 stack with one shared attention block every
6 layers [arXiv:2411.15242] (port of ``repro/configs/zamba2_2p7b.py``,
field for field)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    shared_attn_heads=32,
    shared_attn_kv_heads=32,
    shared_d_ff=10240,
    activation="gelu",
    sub_quadratic=True,
))
