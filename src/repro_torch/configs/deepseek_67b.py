"""deepseek-67b: dense llama-arch. [arXiv:2401.02954; hf]

95L d_model=8192 64H (GQA kv=8, hd=128) d_ff=22016 vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2401.02954; hf",
)
