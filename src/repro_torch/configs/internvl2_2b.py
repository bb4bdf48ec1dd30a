"""internvl2-2b: InternLM2 decoder backbone; InternViT vision frontend is a
stub providing precomputed patch embeddings (per assignment).

[arXiv:2404.16821; hf] 24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_len=256,
    source="arXiv:2404.16821; hf",
)
