"""Shared building blocks: norms, RoPE, MLP variants, embeddings.

Plain functions on tensors with the JAX package's names and arithmetic:
norms and RoPE upcast to f32 exactly where ``repro.models.layers`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig) -> dict:
    d = {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    return d


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        return (x32 * p["scale"].float()).to(dt)
    if kind == "layernorm":
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
        x32 = (x32 - mu) * torch.rsqrt(var + eps)
        return (x32 * p["scale"].float() + p["bias"].float()).to(dt)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary embeddings (with partial-rotary support: stablelm 25%, nemotron 50%)
# ---------------------------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd_rot, 2, dtype=torch.float32, device=device) / hd_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Interleaved pairs (x[..., ::2], x[..., 1::2]), not rotate-half."""
    hd = x.shape[-1]
    hd_rot = int(hd * pct)
    hd_rot -= hd_rot % 2
    if hd_rot == 0:
        return x
    xr, xp = x[..., :hd_rot], x[..., hd_rot:]
    freqs = rope_freqs(hd_rot, theta, device=x.device)       # (hd_rot/2,)
    ang = positions[..., None, None].float() * freqs          # (..., S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., ::2].float(), xr[..., 1::2].float()
    ro = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    ro = ro.reshape(xr.shape).to(x.dtype)
    return torch.cat([ro, xp], dim=-1) if hd_rot < hd else ro


# ---------------------------------------------------------------------------
# MLPs: swiglu | geglu | gelu | relu2
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wg": ParamDef((D, Fd), ("embed", "mlp")),
            "wu": ParamDef((D, Fd), ("embed", "mlp")),
            "wd": ParamDef((Fd, D), ("mlp", "embed")),
        }
    return {
        "wi": ParamDef((D, Fd), ("embed", "mlp")),
        "wd": ParamDef((Fd, D), ("mlp", "embed")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
        return h @ p["wd"].to(dt)
    h = x @ p["wi"].to(dt)
    if kind == "gelu":
        h = _gelu(h)
    elif kind == "relu2":                 # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return h @ p["wd"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / head (with physical vocab padding, Megatron-style)
# ---------------------------------------------------------------------------

VOCAB_PAD_MULTIPLE = 128


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def embed_defs(cfg: ModelConfig) -> dict:
    vp = padded_vocab(cfg.vocab_size)
    d = {"tokens": ParamDef((vp, cfg.d_model), ("vocab", "embed"), "small_normal")}
    if not cfg.tie_embeddings:
        d["head"] = ParamDef((cfg.d_model, vp), ("embed", "vocab"))
    return d


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    x = p["tokens"][tokens].to(dtype)       # gather, then cast: same values
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def lm_logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tokens"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
