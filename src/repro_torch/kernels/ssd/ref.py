"""Plain PyTorch versions of the SSD (Mamba-2) kernel: the naive sequential
recurrence ``ssd_ref`` (mirrors the JAX oracle ``repro.kernels.ssd.ref``),
the chunked algorithm ``_ssd_chunked`` (mirrors
``repro.models.ssm._ssd_chunked``), which the CPU path runs and the CUDA
kernel is held against, and its vjp ``ssd_bwd_ref``, which the CPU
backward runs and the CUDA backward is held against."""

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


def _clip_grad(v: torch.Tensor) -> torch.Tensor:
    """1 where ``torch.clamp(v, -60, 0)`` passes its gradient (inside the
    bounds, the bounds included), else 0."""
    return ((v >= -60.0) & (v <= 0.0)).to(v.dtype)


def ssd_bwd_ref(x, dt, A, B, C, chunk: int, gy, gstate=None):
    """The vjp of ``_ssd_chunked`` written out in the phases the CUDA
    backward runs (not autograd). gy: (b,S,H,P), gstate: (b,H,N,P) or
    None (no gradient reaches the final state).

    Per chunk and head, with G = C B^T, L, w, g, e^cum and the entering
    state S_prev as ``_ssd_chunked`` computes them:
      (i)   lam_k, the gradient of the state leaving chunk k, from the
            last chunk back: lam_last = gstate, lam_{k-1} = g_k lam_k +
            (C e^cum)^T dY_k; dg_k = <lam_k, S_prev_k>;
      (ii)  dX = (G o L)^T dY + diag(w) B lam_k;
      (iii) dP = dY X^T a head; dC = sum_h (dP o L) B + sum_h diag(e^cum)
            dY S_prev^T, dB = sum_h (dP o L)^T C + sum_h diag(w) X lam_k^T;
      (iv)  the gradient of every clipped exponent (of L, w, g and e^cum),
            each the sum of d(dt A) over a range of the chunk, added to
            d(dt A) at every position of its range (sums over pairs,
            prefixes and suffixes inside the chunk): ddt = d(dt A) A + the
            direct terms of L and w, dA = sum d(dt A) dt.
    A clipped exponent passes its gradient as ``torch.clamp`` does; ddt's
    direct terms are products (no division by dt, which a padded tail
    sets to 0). Returns (dx, ddt, dA, dB, dC), float32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xq = x.float().reshape(b, nc, chunk, H, P)
    dtq = dt.float().reshape(b, nc, chunk, H)
    Bq = B.float().reshape(b, nc, chunk, N)
    Cq = C.float().reshape(b, nc, chunk, N)
    A = A.float()
    dy = gy.float().reshape(b, nc, chunk, H, P)

    # ---- the forward's quantities, as _ssd_chunked computes them ----------
    cum = torch.cumsum(dtq * A, dim=2)                     # (b,nc,Q,H)
    seg = cum[:, :, -1]                                    # (b,nc,H)
    G = torch.einsum("bcin,bcjn->bcij", Cq, Bq)            # (b,nc,Q,Q)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    d_ij = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,Q,Q,H)
    E = torch.where(causal, torch.exp(torch.clamp(d_ij, -60.0, 0.0)), 0.0)
    L = E * dtq[:, :, None, :, :]
    W = torch.exp(torch.clamp(seg[:, :, None, :] - cum, -60.0, 0.0))
    w = W * dtq                                            # (b,nc,Q,H)
    g = torch.exp(torch.clamp(seg, -60.0, 0.0))            # (b,nc,H)
    e = torch.exp(torch.clamp(cum, -60.0, 0.0))            # (b,nc,Q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w, Bq, xq)
    s = torch.zeros_like(s_chunk[:, 0])
    s_prev = []
    for c in range(nc):
        s_prev.append(s)
        s = g[:, c, :, None, None] * s + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)                    # (b,nc,H,N,P)

    # ---- (i) the reverse pass over chunks ----------------------------------
    u = torch.einsum("bcih,bcin,bcihp->bchnp", e, Cq, dy)  # (C e^cum)^T dY
    lam = torch.zeros_like(s_chunk[:, 0]) if gstate is None \
        else gstate.float()
    lams = [None] * nc
    for c in reversed(range(nc)):
        lams[c] = lam
        lam = g[:, c, :, None, None] * lam + u[:, c]
    lam = torch.stack(lams, dim=1)                         # (b,nc,H,N,P)
    dg = (lam * s_prev).sum((-2, -1))                      # (b,nc,H)

    # ---- (ii) dX ------------------------------------------------------------
    Blam = torch.einsum("bcjn,bchnp->bcjhp", Bq, lam)      # B lam_k
    dx = (torch.einsum("bcij,bcijh,bcihp->bcjhp", G, L, dy)
          + w[..., None] * Blam)

    # ---- (iii) dP, dC and dB -------------------------------------------------
    dP = torch.einsum("bcihp,bcjhp->bcijh", dy, xq)        # (b,nc,Q,Q,H)
    dG = (dP * L).sum(-1)                                  # summed over heads
    dC = (torch.einsum("bcij,bcjn->bcin", dG, Bq)
          + torch.einsum("bcih,bcihp,bchnp->bcin", e, dy, s_prev))
    dB = (torch.einsum("bcij,bcin->bcjn", dG, Cq)
          + torch.einsum("bcjh,bcjhp,bchnp->bcjn", w, xq, lam))

    # ---- (iv) the exponents, into d(dt A) over their ranges ---------------
    # cum_i - cum_j is the sum of d(dt A) over (j, i]: its gradient R_ij
    # goes to every m with j < m <= i (each row's exclusive prefix over j,
    # summed over the rows i >= m). The diagonal's exponent is 0 whatever
    # cum is, so it has none. Summed this way, no term cancels another
    # (a cumsum of R's row sums less its column sums would, and lose
    # float32 digits at a strong decay)
    dPG = dP * G[..., None]                                # d L
    ddt = (dPG * E).sum(2)                                 # L's direct term
    strict = (ii[:, None] > ii[None, :])[None, None, :, :, None]
    R = torch.where(strict, dPG * L * _clip_grad(d_ij), 0.0)
    T = torch.cumsum(R, 3) - R
    dda = torch.where(causal, T, 0.0).sum(2)
    # cum_i, the sum over [0, i]: e^cum_i's gradient to every m <= i
    de = torch.einsum("bcin,bchnp,bcihp->bcih", Cq, s_prev, dy)
    dce = de * e * _clip_grad(cum)                         # e^cum_i
    dda = dda + torch.flip(torch.cumsum(torch.flip(dce, (2,)), 2), (2,))
    # seg - cum_j is the sum over (j, Q): w_j's exponent adds to d(dt A)
    # after j (an exclusive prefix sum), seg's through g to all of them.
    # The clip is tested on that sum itself, 0 over a zero tail, where
    # seg - cum_j of a cumsum in another order may round above 0
    da = dtq * A
    after = torch.flip(torch.cumsum(torch.flip(da, (2,)), 2), (2,)) - da
    dw = (Blam * xq).sum(-1)                               # (b,nc,Q,H)
    ddt = ddt + dw * W                                     # w's direct term
    dwe = dw * w * _clip_grad(after)                       # d (seg - cum_j)
    dda = dda + torch.cumsum(dwe, 2) - dwe
    dda = dda + (dg * g * _clip_grad(seg))[:, :, None]
    ddt = ddt + dda * A
    dA = (dda * dtq).sum((0, 1, 2))
    return (dx.reshape(b, S, H, P), ddt.reshape(b, S, H), dA,
            dB.reshape(b, S, N), dC.reshape(b, S, N))
