"""Shared building blocks: norms, RoPE, MLP variants, embeddings.

Plain functions on tensors with the JAX package's names and arithmetic:
norms and RoPE upcast to f32 exactly where ``repro.models.layers`` does.

On a rank of a ``model`` axis (``axis``: a ``dist.sharding.ModelAxis``)
the weights are the rank's shards, as the JAX package's specs split them:
the MLP is column-split in (``wg``/``wu``/``wi`` on F) and row-split out
(``wd``), ``rms_gated`` normalises over the ranks' slices together, the
embedding and the head are vocab-parallel (the rank holds
rows ``[c * Vp/tp, (c+1) * Vp/tp)`` for its coordinate ``c``). With
``axis=None`` (``model`` at 1) nothing changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (ModelAxis, copy_to_model,
                                       reduce_from_model, sum_over_model)
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


def rms_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
              eps: float = 1e-6, axis: ModelAxis | None = None
              ) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: rmsnorm(x * silu(z)) * scale.

    On a model axis ``x``, ``z`` and ``scale`` are the rank's slice of
    ``d_inner``, while the mean runs over the whole of it (the reference's
    norm): the slices' sums of squares are summed over the axis by
    ``sum_over_model``, whose backward sums too -- every rank's
    normalisation depends on every slice (neither ``copy_to_model`` nor
    ``reduce_from_model`` is that operator)."""
    dt = x.dtype
    y = x.float() * F.silu(z.float())
    if axis is None:
        ms = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        ms = (sum_over_model((y * y).sum(dim=-1, keepdim=True), axis)
              / (y.shape[-1] * axis.size))
    y = y * torch.rsqrt(ms + eps)
    return (y * scale.float()).to(dt)


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


def apply_mlp(p: dict, x: torch.Tensor, kind: str,
              axis: ModelAxis | None = None) -> torch.Tensor:
    """The MLP; on a model axis ``x`` enters the region, the rank's F
    columns run, and its partial output sums over the axis."""
    dt = x.dtype
    x = copy_to_model(x, axis)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
        return reduce_from_model(h @ p["wd"].to(dt), axis)
    h = x @ p["wi"].to(dt)
    if kind == "gelu":
        h = _gelu(h)
    elif kind == "relu2":                 # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return reduce_from_model(h @ p["wd"].to(dt), axis)


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
                 dtype: torch.dtype,
                 axis: ModelAxis | None = None) -> torch.Tensor:
    if axis is None:
        x = p["tokens"][tokens].to(dtype)   # gather, then cast: same values
    else:
        # vocab-parallel: each rank gathers the tokens of its rows, zeros
        # elsewhere, and the sum over the axis holds one row a token
        rows = p["tokens"].shape[0]
        local = tokens - axis.coord * rows
        mine = (local >= 0) & (local < rows)
        x = p["tokens"][torch.where(mine, local, 0)].to(dtype)
        x = reduce_from_model(x.masked_fill(~mine[..., None], 0), axis)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype,
                             device=x.device)
    return x


def lm_logits(p: dict, x: torch.Tensor, cfg: ModelConfig,
              axis: ModelAxis | None = None) -> torch.Tensor:
    """(B, S, Vp) logits; on a model axis the rank's vocab slice."""
    x = copy_to_model(x, axis)
    if cfg.tie_embeddings:
        return x @ p["tokens"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)
