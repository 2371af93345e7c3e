"""Qwen3-MoE 235B-A22B: 128 experts top-8, qk-norm GQA(kv=4)
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    qk_norm=True,
    activation="silu",
    rope_theta=1e6,
))
