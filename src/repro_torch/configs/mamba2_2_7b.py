"""mamba2-2.7b: attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 64L d_model=2560, d_inner=5120 (expand 2),
headdim 64 (80 ssm heads), state 128, vocab 50280.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    conv_kernel=4,
    source="arXiv:2405.21060; unverified",
)
