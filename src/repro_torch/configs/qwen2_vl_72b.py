"""Qwen2-VL-72B backbone: M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
The vision frontend is a stub, as in the JAX package: the batch carries
precomputed patch/text embeddings (``inputs_embeds``) and the t/h/w M-RoPE
positions ``[B, 3, S]``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    activation="silu",
    frontend="vision",
))
