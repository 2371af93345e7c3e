"""StarCoder2-3B: GQA(kv=2), RoPE, non-gated GELU MLP [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    activation="gelu",
    mlp_gated=False,
    rope_theta=1e5,
))
