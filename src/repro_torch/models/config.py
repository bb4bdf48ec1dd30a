"""Model + shape-cell configuration schema for the 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # block flavour
    mlp: str = "swiglu"              # swiglu | gelu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    parallel_block: bool = False     # stablelm/gpt-neox style parallel attn+ffn
    rope_theta: float = 10000.0
    rope_pct: float = 1.0            # partial rotary (stablelm 0.25, nemotron 0.5)
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d_model) embedding scale
    attn_kind: str = "full"          # full | local (sliding window)
    window: int = 0                  # local-attention window size
    attn_score_dtype: str = "float32"  # bfloat16 halves score-chain traffic
                                     # (f32 running stats kept either way)
    attn_q_chunk: int = 2048         # chunked-attention tile sizes (XLA path);
    attn_kv_chunk: int = 2048        # larger tiles = fewer renorm passes,
                                     # more live score bytes

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense layers (Moonlight style)
    moe_every: int = 1               # MoE layer cadence (1 = every layer)
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256             # SSD chunk length
    conv_kernel: int = 4

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: tuple[str, ...] = ()   # repeating cycle, e.g. ("rec","rec","attn")
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)

    # modality frontend stub
    frontend: str = ""               # "" | "audio" | "vision"
    frontend_len: int = 0            # prefix positions fed by the stub frontend

    source: str = ""                 # citation tag from the assignment table

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_types(self) -> tuple[str, ...]:
        """Per-layer block type, resolving pattern / MoE cadence / SSM."""
        out = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                out.append("ssm")
            elif self.block_pattern:
                out.append(self.block_pattern[i % len(self.block_pattern)])
            elif self.n_experts and i >= self.first_k_dense and (
                (i - self.first_k_dense) % self.moe_every == 0
            ):
                out.append("moe")
            else:
                out.append("attn")
        return tuple(out)

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        D, V = self.d_model, self.vocab_size
        n = V * D                                # token embedding
        if not self.tie_embeddings:
            n += D * V                           # output head
        hd = self.head_dim_
        for t in self.layer_types():
            n += 2 * D                           # two norms (scale only, approx)
            if t in ("attn", "moe"):
                n += D * self.n_heads * hd       # wq
                n += 2 * D * self.n_kv_heads * hd  # wk, wv
                n += self.n_heads * hd * D       # wo
            if t == "attn":
                n += self._mlp_params(self.d_ff)
            elif t == "moe":
                n += D * self.n_experts          # router
                e = self.top_k if active_only else self.n_experts
                n += e * self._mlp_params(self.expert_d_ff)
                n += self.n_shared_experts * self._mlp_params(self.expert_d_ff)
            elif t == "ssm":
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n += D * (2 * di + 2 * ds + nh)  # in_proj (z,x,B,C,dt)
                n += (di + 2 * ds) * self.conv_kernel  # conv1d
                n += 2 * nh + di                 # A_log, D, gate-norm
                n += di * D                      # out_proj
            elif t == "rec":
                dr = self.rnn_width_
                n += 2 * D * dr                  # two input branches
                n += dr * (self.conv_kernel + 1)  # temporal conv + bias
                n += 2 * (dr * dr // 16 + dr)    # block-diag gates (16 blocks)
                n += dr                          # Lambda
                n += dr * D                      # out proj
                n += self._mlp_params(self.d_ff)  # Griffin blocks pair w/ MLP
        return n

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(kw) - known
        if bad:
            raise ValueError(f"unknown ModelConfig overrides: {sorted(bad)}")
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/block structure, tiny dims."""
        pat = self.block_pattern
        n_layers = max(len(pat), 2) if pat else (3 if self.first_k_dense else 2)
        kv = min(self.n_kv_heads, 2) if self.n_heads else 0
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers if self.family != "ssm" else 2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=kv,
            head_dim=16 if self.n_heads else 0,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            first_k_dense=min(self.first_k_dense, 1),
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            rnn_width=64 if self.block_pattern else 0,
            window=min(self.window, 16) if self.window else 0,
            frontend_len=min(self.frontend_len, 4),
        )

    def _mlp_params(self, d_ff: int) -> int:
        mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mats * self.d_model * d_ff


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell. ``kind`` selects the lowered step."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    def scaled(self, seq_len: int | None = None, global_batch: int | None = None) -> "ShapeCell":
        return replace(
            self,
            name=self.name + "-scaled",
            seq_len=seq_len or self.seq_len,
            global_batch=global_batch or self.global_batch,
        )


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def get_shape_cell(name: str) -> ShapeCell:
    try:
        return SHAPE_CELLS[name]
    except KeyError:
        raise KeyError(f"unknown shape cell {name!r}; have {sorted(SHAPE_CELLS)}") from None


def long_context_capable(cfg: ModelConfig) -> bool:
    """Whether the arch is sub-quadratic in cached context (SSM/hybrid/linear).

    Pure full-attention archs skip ``long_500k`` (see DESIGN.md §4).
    ``attn`` and ``moe`` blocks both carry attention; they only count as
    sub-quadratic when the arch uses windowed (local) attention.
    """
    types = set(cfg.layer_types())
    has_attention = bool(types & {"attn", "moe"})
    return (not has_attention) or cfg.attn_kind == "local"
