"""Plain PyTorch versions of the flash-attention kernels: the forward
(mirrors the JAX oracle ``repro.kernels.flash_attention.ref``), its rows'
log-sum-exp L, and the backward from L (the equations of
``csrc/flash_attention_bwd.cu``, dense, in float32)."""

from __future__ import annotations

import torch


def _mask(Sq: int, Sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query row sees."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        # q position i attends to k positions <= i + (Sk - Sq)
        mask &= ki <= qi + (Sk - Sq)
    if window:
        mask &= ki > qi + (Sk - Sq) - window
    return mask


def _scores(q, k, causal, window, scale):
    """Scaled f32 scores (B, Hkv, g, Sq, Sk), -inf where not seen, and the
    scale used."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    mask = _mask(Sq, Sk, causal, window, q.device)
    return torch.where(mask[None, None, None], s, float("-inf")), scale


def _out(s, v, q):
    """The forward's output from ``_scores``' s, in q's dtype."""
    B, Hq, Sq, d = q.shape
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)        # fully-masked rows -> 0
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, d).to(q.dtype)


def _lse(s, q):
    """Each row's L from ``_scores``' s, +inf on a row that sees no key."""
    B, Hq, Sq, _ = q.shape
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    return lse.reshape(B, Hq, Sq)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); Hq % Hkv == 0.

    Returns (B, Hq, Sq, d). Full-softmax reference in f32.
    """
    return _out(_scores(q, k, causal, window, scale)[0], v, q)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            scale: float | None = None) -> torch.Tensor:
    """The forward's L: each query row's log-sum-exp of its scaled scores
    over the keys it sees, float32 (B, Hq, Sq). A row that sees no key
    (the forward writes it zeros) gets +inf, so exp(s - L) is 0 there."""
    return _lse(_scores(q, k, causal, window, scale)[0], q)


def _out_lse_ref(q, k, v, causal, window, scale):
    """``flash_attention_ref``'s out and ``flash_attention_lse_ref``'s L
    from one pass over the scores (the CPU route of a forward that keeps
    L for its backward); the same bits as the two calls."""
    s, _ = _scores(q, k, causal, window, scale)
    return _out(s, v, q), _lse(s, q)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            scale: float | None = None):
    """(dq, dk, dv) of the forward at (q, k, v) for the cotangent ``dout``,
    from the forward's ``out`` and L (``lse``), dense in float32:

        P = exp(scale q k^T - L)     (0 where not seen)
        D = rowsum(dout * out)
        dS = P (dout v^T - D)
        dv = P^T dout,  dk = scale dS^T q,  dq = scale dS k

    summed over each kv head's GQA group; each grad in its input's dtype."""
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    s, scale = _scores(q, k, causal, window, scale)
    L = lse.reshape(B, Hkv, g, Sq, 1).float()
    p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - L))
    qg = q.reshape(B, Hkv, g, Sq, d).float()
    do = dout.reshape(B, Hkv, g, Sq, d).float()
    D = (do * out.reshape(B, Hkv, g, Sq, d).float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", do, v.float()) - D)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    return (dq.reshape(B, Hq, Sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
