"""stablelm-3b: LayerNorm, MHA (kv=32), partial rotary 25%.

[hf:stabilityai/stablelm-2-1_6b; unverified] 32L d_model=2560 32H (kv=32)
d_ff=6912 vocab=50304.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
    mlp="swiglu",
    norm="layernorm",
    rope_theta=10_000.0,
    rope_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
