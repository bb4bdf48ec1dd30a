"""moonshot-v1-16b-a3b: Moonlight-style fine-grained MoE, 64e top-6,
2 shared experts, first layer dense.

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=163840.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_k_dense=1,
    moe_every=1,
    moe_d_ff=1408,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
