"""llama4-scout-17b-a16e: MoE 16 experts top-1 + shared expert, every layer.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H (kv=8)
expert d_ff=8192 vocab=202048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_every=1,
    moe_d_ff=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
