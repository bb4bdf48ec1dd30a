"""recurrentgemma-2b: RG-LRU + local attention hybrid, 2:1 cycle.

[arXiv:2402.19427; hf] -- Griffin architecture, 26L d_model=2560, 10 heads
(MQA kv=1, head_dim 256), GeGLU d_ff=7680, vocab 256000, window 2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    attn_kind="local",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=2560,
    conv_kernel=4,
    source="arXiv:2402.19427; hf",
)
