"""musicgen-medium: decoder-only over EnCodec tokens; audio frontend is a
stub providing precomputed frame embeddings (per assignment).

[arXiv:2306.05284; hf] 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    frontend="audio",
    frontend_len=64,
    source="arXiv:2306.05284; hf",
)
