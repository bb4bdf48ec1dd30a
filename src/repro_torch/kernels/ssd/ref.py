"""Plain PyTorch versions of the SSD (Mamba-2) kernel: the naive sequential
recurrence ``ssd_ref`` (mirrors the JAX oracle ``repro.kernels.ssd.ref``)
and the chunked algorithm ``_ssd_chunked`` (mirrors
``repro.models.ssm._ssd_chunked``), which the CPU path runs and the CUDA
kernel is held against."""

from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Sequential state-space recurrence (ground truth, O(S·H·N·P)).

    x: (b,S,H,P); dt: (b,S,H) >0; A: (H,) <0; B,C: (b,S,N).
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t ;  y_t = C_t . h_t
    Returns y: (b,S,H,P) f32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A)                               # (b,H)
        h = a[..., None, None] * h + torch.einsum(
            "bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1)


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan. x: (b,S,H,P); dt: (b,S,H); A: (H,)<0; B,C: (b,S,N).

    Returns (y (b,S,H,P), final state (b,H,N,P)). Group count fixed at 1
    (per the 2.7b config)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xq = x.reshape(b, nc, chunk, H, P)
    dtq = dt.reshape(b, nc, chunk, H)
    Bq = B.reshape(b, nc, chunk, N)
    Cq = C.reshape(b, nc, chunk, N)

    da = dtq * A                                           # (b,nc,Q,H) negative
    cum = torch.cumsum(da, dim=2)                          # inclusive cumsum
    seg_total = cum[:, :, -1]                              # (b,nc,H)

    # ---- intra-chunk (quadratic in chunk length) ---------------------------
    scores = torch.einsum("bcin,bcjn->bcij", Cq, Bq)       # (b,nc,Q,Q)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # decay L[i,j] = exp(cum_i - cum_j) * dt_j   per head
    L = torch.exp(torch.clamp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :], -60.0, 0.0)
    ) * dtq[:, :, None, :, :]                              # (b,nc,Q,Q,H)
    L = torch.where(causal[None, None, :, :, None], L, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xq)

    # ---- chunk boundary states ---------------------------------------------
    wts = torch.exp(torch.clamp(seg_total[:, :, None, :] - cum, -60.0, 0.0)) * dtq
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", wts, Bq, xq)

    # ---- inter-chunk recurrence: S_k = g_k * S_{k-1} + S_chunk_k ------------
    g = torch.exp(torch.clamp(seg_total, -60.0, 0.0))      # (b,nc,H)
    s = torch.zeros_like(s_chunk[:, 0])
    s_prev = []                                            # state *entering* c
    for c in range(nc):
        s_prev.append(s)
        s = g[:, c, :, None, None] * s + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)                    # (b,nc,H,N,P)

    # ---- inter-chunk contribution -------------------------------------------
    cin = Cq[:, :, :, None, :] * torch.exp(
        torch.clamp(cum, -60.0, 0.0))[..., None]           # (b,nc,Q,H,N)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", cin, s_prev)

    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y, s                                            # (.., final state)
