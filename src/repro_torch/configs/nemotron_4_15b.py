"""nemotron-4-15b: dense, GQA, squared-ReLU MLP, partial rotary 50%.

[arXiv:2402.16819; unverified] 32L d_model=6144 48H (kv=8) d_ff=24576
vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256_000,
    mlp="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    rope_pct=0.5,
    source="arXiv:2402.16819; unverified",
)
