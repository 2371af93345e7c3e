"""DeepSeek-V2 236B: MLA (kv_lora=512) + MoE 160 experts top-6 with 2 shared
experts; first layer dense [arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,          # the first (dense) layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    top_k=6,
    moe_d_ff=1536,
    num_shared_experts=2,
    first_dense_layers=1,
    activation="silu",
))
