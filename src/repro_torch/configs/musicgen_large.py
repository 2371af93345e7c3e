"""MusicGen-large backbone: decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284; hf].  The audio frontend is a stub, as in the JAX
package: the batch carries precomputed (codebook-summed) frame embeddings
(``inputs_embeds``), and the head is one ``[d, vocab]`` projection per
codebook; text-conditioning cross-attention is omitted."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="dense",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    mlp_gated=False,
    frontend="audio",
    num_codebooks=4,
))
