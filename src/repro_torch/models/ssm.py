"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060].

Chunked SSD algorithm (quadratic within a chunk, linear across chunks):

  per chunk of length Q:
    L[i,j]   = exp(cum_a_i - cum_a_j) * dt_j        (i >= j, intra-chunk decay)
    Y_intra  = ((C B^T) .* L) X
    S_chunk  = sum_j exp(cum_a_last - cum_a_j) dt_j B_j (x) X_j   (H,N,P)
  across chunks:
    S_k      = exp(sum_a_k) S_{k-1} + S_chunk_k
    Y_inter  = (C_i exp(cum_a_i)) . S_{k-1}
  Y = Y_intra + Y_inter + D*X, then gated RMSNorm and out-projection.

Parameter layouts, names and arithmetic follow ``repro.models.ssm``
(separate wz/wx/wB/wC/wdt projections). ``ssm_forward`` runs the scan
through ``kernels.ssd`` (the CUDA kernel on a card, the plain chunked
``kernels.ssd.ref._ssd_chunked`` on the CPU); decode is the O(1)
recurrence in plain PyTorch, as the JAX package runs it through XLA:
h = exp(dt*A) h + dt * B (x) x ; y = C.h + D x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (ModelAxis, copy_to_model,
                                       gather_from_model, once_over_model,
                                       reduce_from_model)
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_gated
from repro_torch.models.params import ParamDef


def ssm_defs(cfg: ModelConfig) -> dict:
    D, di, ds, nh, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.conv_kernel)
    conv_ch = di + 2 * ds      # conv runs over (x, B, C) channels
    return {
        "wz": ParamDef((D, di), ("embed", "rnn")),
        "wx": ParamDef((D, di), ("embed", "rnn")),
        "wB": ParamDef((D, ds), ("embed", None)),
        "wC": ParamDef((D, ds), ("embed", None)),
        "wdt": ParamDef((D, nh), ("embed", "heads")),
        "conv_w": ParamDef((conv_ch, K), ("rnn", None), "normal", 0.1),
        "conv_b": ParamDef((conv_ch,), ("rnn",), "zeros"),
        "A_log": ParamDef((nh,), ("heads",), "normal", 0.5),
        "D": ParamDef((nh,), ("heads",), "ones"),
        "dt_bias": ParamDef((nh,), ("heads",), "zeros"),
        "gate_norm": ParamDef((di,), ("rnn",), "ones"),
        "out": ParamDef((di, D), ("rnn", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU. x: (B,S,Ch), w: (Ch,K)."""
    K = w.shape[1]
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))            # (B,Ch,S+K-1)
    out = F.conv1d(xp, w[:, None, :], groups=x.shape[-1]).transpose(1, 2)
    return F.silu(out + b)


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_cache: bool = False, axis: ModelAxis | None = None):
    """Training/prefill forward. x: (B,S,D) -> (B,S,D) [, decode cache].

    Padded tail steps (to a chunk multiple) only influence later positions,
    so real outputs are unaffected; BUT the final *state* must be taken at
    the true position S, so a cached prefill must be chunk-divisible (the
    reference's rule, kept as it is: a prompt longer than ``ssm_chunk``
    that is not a multiple of it raises).

    On a model axis (``axis``; no cache) the rank runs its ``rnn`` slice of
    ``d_inner`` (``wz``, ``wx``, ``gate_norm``, the rows of ``out``) and
    its ``heads`` (``wdt``, ``A_log``, ``D``, ``dt_bias``; ``xi`` reshapes
    to (B, S, nh/tp, P), since d_inner = nh P), inside one split region
    that ``x`` enters through ``copy_to_model`` and the out projection's
    partial sum leaves through ``reduce_from_model``. B and C are shared
    by every head: their products and conv are replicated math outside the
    region, and enter it through ``copy_to_model`` as the scan's float32
    inputs. The conv and the norm are ``_conv_on_model``'s and
    ``rms_gated``'s traps."""
    Bsz, S, D = x.shape
    di, ds, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    dt_ = x.dtype

    xr = copy_to_model(x, axis)
    z = xr @ p["wz"].to(dt_)
    xi = xr @ p["wx"].to(dt_)
    Bm = x @ p["wB"].to(dt_)
    Cm = x @ p["wC"].to(dt_)
    dt = xr @ p["wdt"].to(dt_)

    if axis is None:
        conv_in = torch.cat([xi, Bm, Cm], dim=-1)
        conv_out = _causal_conv(conv_in, p["conv_w"].to(dt_),
                                p["conv_b"].to(dt_))
        xi, Bm, Cm = torch.split(conv_out, [di, ds, ds], dim=-1)
    else:
        xi, Bm, Cm = _conv_on_model(p, xi, Bm, Cm, di, axis)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                     # (H,)

    nh = dt.shape[-1]                                      # the rank's heads
    xh = xi.reshape(Bsz, S, nh, P)
    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    if pad and return_cache:
        raise ValueError(f"prefill length {S} must be divisible by ssm_chunk "
                         f"{chunk} when a decode cache is requested")
    # B and C enter the heads' region in float32, where each rank's heads
    # add their part of B's and C's gradient (GSPMD's all-reduce of the
    # scan's head-summed float32 gradient, not of a bf16-rounded one)
    xs, dts = xh.float(), dt
    Bs, Cs = copy_to_model(Bm.float(), axis), copy_to_model(Cm.float(), axis)
    if pad:
        # zero-pad the tail to a chunk multiple; padded steps only influence
        # later (sliced-off) positions, so real outputs are unaffected.
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dts = F.pad(dts, (0, 0, 0, pad))
        Bs = F.pad(Bs, (0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, pad))
    y, final_state = ssd(xs.contiguous(), dts.contiguous(), A.contiguous(),
                         Bs.contiguous(), Cs.contiguous(), chunk)
    if pad:
        y = y[:, :S]
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, nh * P).to(dt_)

    y = rms_gated(y, z, p["gate_norm"], axis=axis)
    out = reduce_from_model(y @ p["out"].to(dt_), axis)
    if return_cache:
        cache = {"conv": conv_in[:, -(cfg.conv_kernel - 1):],
                 "state": final_state}
        return out, cache
    return out


def _conv_on_model(p: dict, xi, Bm, Cm, di: int, axis: ModelAxis):
    """The causal conv of a model-axis rank: its ``xi`` channels, and the
    B and C channels as replicated math.

    The trap: ``conv_w``/``conv_b`` hold conv_ch = d_inner + 2 ssm_state
    rows, split on ``rnn`` into tp equal blocks that do not line up with
    ``xi``'s d_inner / tp (tp 2 at full width: rows 2688 | 2688 against
    2560 | 2560; mamba2-smoke 80 | 80 against 64 | 64), so a rank's block
    holds channels of another rank's ``xi``, and the B/C rows sit on the
    last rank. The rows are gathered whole (``gather_from_model``: its
    backward sums the ranks' gradients and hands each rank its rows): a
    rank reads the rows of its own channels, whose gradient only it adds,
    and the B/C rows through ``once_over_model``, whose gradient every
    rank computes alike and only the first adds -- so each row gets its
    gradient exactly once. A conv leaf the axis does not divide stays
    whole on every rank and enters through ``copy_to_model`` instead."""
    dt_ = xi.dtype
    whole = p["conv_w"].shape[0] == di + 2 * Bm.shape[-1]
    enter = copy_to_model if whole else gather_from_model
    w, b = enter(p["conv_w"], axis), enter(p["conv_b"], axis)
    n = xi.shape[-1]
    lo = axis.coord * n
    xi = _causal_conv(xi, w[lo:lo + n].to(dt_), b[lo:lo + n].to(dt_))
    bc = _causal_conv(torch.cat([Bm, Cm], dim=-1),
                      once_over_model(w[di:], axis).to(dt_),
                      once_over_model(b[di:], axis).to(dt_))
    Bm, Cm = torch.split(bc, [Bm.shape[-1]] * 2, dim=-1)
    return xi, Bm, Cm


# ---------------------------------------------------------------------------
# decode (O(1) state update)
# ---------------------------------------------------------------------------

def init_ssm_cache(n_layers: int, batch: int, cfg: ModelConfig,
                   dtype: torch.dtype, device=None) -> dict:
    di, ds, nh, P, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                        cfg.ssm_headdim, cfg.conv_kernel)
    return {
        "conv": torch.zeros((n_layers, batch, K - 1, di + 2 * ds),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, nh, ds, P),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B,1,D); cache: {conv (B,K-1,Ch), state (B,H,N,P)}.
    Returns (out (B,1,D), new cache entries)."""
    Bsz = x.shape[0]
    di, ds, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    dt_ = x.dtype
    xt = x[:, 0]                                           # (B,D)

    z = xt @ p["wz"].to(dt_)
    xi = xt @ p["wx"].to(dt_)
    Bm = xt @ p["wB"].to(dt_)
    Cm = xt @ p["wC"].to(dt_)
    dt = xt @ p["wdt"].to(dt_)

    conv_in = torch.cat([xi, Bm, Cm], dim=-1)              # (B,Ch)
    win = torch.cat([cache["conv"].to(dt_), conv_in[:, None]], dim=1)  # (B,K,Ch)
    conv_out = torch.einsum("bkc,ck->bc", win, p["conv_w"].to(dt_))
    conv_out = F.silu(conv_out + p["conv_b"].to(dt_))
    xi, Bm, Cm = torch.split(conv_out, [di, ds, ds], dim=-1)
    new_conv = win[:, 1:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                                  # (B,H)

    xh = xi.reshape(Bsz, nh, P).float()
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), xh)
    state = a[..., None, None] * cache["state"].float() + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), state)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(Bsz, di).to(dt_)

    y = rms_gated(y, z, p["gate_norm"])
    out = (y @ p["out"].to(dt_))[:, None]                  # (B,1,D)
    return out, {"conv": new_conv, "state": state}
