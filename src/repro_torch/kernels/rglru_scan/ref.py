"""Plain PyTorch version of the RG-LRU linear-recurrence kernel (mirrors the
JAX oracle ``repro.kernels.rglru_scan.ref``)."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: (B, S, R) f32;  h0: (B, R) initial state (zeros if None).
    Sequential scan in f32 -- the ground truth the kernel is checked
    against, and the CPU path of the model's prefill.
    """
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=a.dtype, device=a.device)
         if h0 is None else h0)
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
