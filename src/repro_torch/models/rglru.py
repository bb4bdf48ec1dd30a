"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Block layout (the paper's "recurrent block"):

    x -(wy)-> GeLU --------------------------\\
    x -(wx)-> causal conv1d -> RG-LRU -> h --(*)--> (wo) -> out

RG-LRU recurrence (per channel):
    r_t = sigmoid(BlockDiag_a(x_t))          recurrence gate
    i_t = sigmoid(BlockDiag_x(x_t))          input gate
    a_t = exp(c * softplus(Lambda) * (-r_t)) i.e. a^(c r_t), a=sigmoid(Lambda)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Parameter layouts, names and arithmetic follow ``repro.models.rglru``
(block-diagonal gates with RGLRU_BLOCKS = 16 blocks). Prefill runs the
recurrence through ``kernels.rglru_scan`` (the CUDA kernel on a card, the
sequential plain version on the CPU) where the JAX package runs an
associative scan; decode is the O(1) recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (ModelAxis, copy_to_model,
                                       reduce_from_model)
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _gelu
from repro_torch.models.params import ParamDef

RGLRU_BLOCKS = 16     # block-diagonal gate blocks
_C = 8.0              # Griffin's fixed temperature on the log-decay


def rec_defs(cfg: ModelConfig) -> dict:
    D, R, K = cfg.d_model, cfg.rnn_width_, cfg.conv_kernel
    nb = RGLRU_BLOCKS
    bs = R // nb
    return {
        "wx": ParamDef((D, R), ("embed", "rnn")),
        "wy": ParamDef((D, R), ("embed", "rnn")),
        "conv_w": ParamDef((R, K), ("rnn", None), "normal", 0.1),
        "conv_b": ParamDef((R,), ("rnn",), "zeros"),
        "gate_a_w": ParamDef((nb, bs, bs), ("rnn", None, None)),
        "gate_a_b": ParamDef((nb, bs), ("rnn", None), "zeros"),
        "gate_x_w": ParamDef((nb, bs, bs), ("rnn", None, None)),
        "gate_x_b": ParamDef((nb, bs), ("rnn", None), "zeros"),
        "lam": ParamDef((R,), ("rnn",), "normal", 1.0),
        "wo": ParamDef((R, D), ("rnn", "embed")),
    }


def _block_linear(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (..., R) with R = nb*bs; w: (nb, bs, bs)."""
    nb, bs, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bs)
    yb = torch.einsum("...ni,nij->...nj", xb, w) + b
    return yb.reshape(*x.shape[:-1], nb * bs)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (no activation). x: (B,S,R), w: (R,K)."""
    K = w.shape[1]
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))            # (B,R,S+K-1)
    out = F.conv1d(xp, w[:, None, :], groups=x.shape[-1]).transpose(1, 2)
    return out + b


def _rglru_coeffs(p: dict, x: torch.Tensor):
    """x: (B,S,R) conv output -> per-step (a, b_in) of h = a*h + b_in."""
    xf = x.float()
    r = torch.sigmoid(_block_linear(xf, p["gate_a_w"].float(),
                                    p["gate_a_b"].float()))
    i = torch.sigmoid(_block_linear(xf, p["gate_x_w"].float(),
                                    p["gate_x_b"].float()))
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = i * xf
    b_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) * gated
    return a, b_in


def rec_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_cache: bool = False, axis: ModelAxis | None = None):
    """Training/prefill. x: (B,S,D) -> (B,S,D) [, decode cache: the raw
    (pre-conv) tail of the input branch and the last step's state].

    On a model axis the block is one split region: ``x`` enters through
    ``copy_to_model``, the rank holds its ``rnn`` channels of ``wx``,
    ``wy``, the conv, ``lam`` and whole gate blocks (16 blocks split over
    the axis, so the channels a rank scans are its blocks' channels), the
    scan runs on its (B, S, R/tp), and the row-split ``wo``'s partial
    output leaves through ``reduce_from_model``."""
    dt_ = x.dtype
    x = copy_to_model(x, axis)
    y = _gelu(x @ p["wy"].to(dt_))
    raw = x @ p["wx"].to(dt_)
    xr = _causal_conv(raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    a, b = _rglru_coeffs(p, xr)
    h = rglru_scan(a.contiguous(), b.contiguous())         # (B,S,R) f32
    out = reduce_from_model((h.to(dt_) * y) @ p["wo"].to(dt_), axis)
    if return_cache:
        return out, {"conv": raw[:, -(cfg.conv_kernel - 1):],
                     "state": h[:, -1]}
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_rec_cache(n_layers: int, batch: int, cfg: ModelConfig,
                   dtype: torch.dtype, device=None) -> dict:
    R, K = cfg.rnn_width_, cfg.conv_kernel
    return {
        "conv": torch.zeros((n_layers, batch, K - 1, R), dtype=dtype,
                            device=device),
        "state": torch.zeros((n_layers, batch, R), dtype=torch.float32,
                             device=device),
    }


def rec_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
               axis: ModelAxis | None = None):
    """x: (B,1,D); cache conv (B,K-1,R), state (B,R).
    Returns (out (B,1,D), new cache entries).

    On a model axis the rank runs its ``rnn`` channels and whole gate
    blocks, as ``rec_forward`` does: its cache is (B,K-1,R/tp) and
    (B,R/tp), the reference's ``rnn`` blocks, and the out projection's
    partial sum leaves through ``reduce_from_model``."""
    dt_ = x.dtype
    xt = copy_to_model(x[:, 0], axis)
    y = _gelu(xt @ p["wy"].to(dt_))
    xr = xt @ p["wx"].to(dt_)
    win = torch.cat([cache["conv"].to(dt_), xr[:, None]], dim=1)    # (B,K,R)
    xr = (torch.einsum("bkr,rk->br", win, p["conv_w"].to(dt_))
          + p["conv_b"].to(dt_))
    a, b = _rglru_coeffs(p, xr[:, None])
    a, b = a[:, 0], b[:, 0]
    state = a * cache["state"].float() + b
    h = state.to(dt_)
    out = reduce_from_model((h * y) @ p["wo"].to(dt_), axis)[:, None]
    return out, {"conv": win[:, 1:], "state": state}
