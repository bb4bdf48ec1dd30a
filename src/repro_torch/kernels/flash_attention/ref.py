"""Plain PyTorch version of the flash-attention forward kernel (mirrors the
JAX oracle ``repro.kernels.flash_attention.ref``)."""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); Hq % Hkv == 0.

    Returns (B, Hq, Sq, d). Full-softmax reference in f32.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(B, Hkv, g, Sq, d).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        # q position i attends to k positions <= i + (Sk - Sq)
        mask &= ki <= qi + (Sk - Sq)
    if window:
        mask &= ki > qi + (Sk - Sq) - window
    s = torch.where(mask[None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)        # fully-masked rows -> 0
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return o.reshape(B, Hq, Sq, d).to(q.dtype)
