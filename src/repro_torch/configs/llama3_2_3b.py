"""llama3.2-3b: small llama3, tied embeddings.

[hf:meta-llama/Llama-3.2-1B; unverified] 28L d_model=3072 24H (kv=8)
d_ff=8192 vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
