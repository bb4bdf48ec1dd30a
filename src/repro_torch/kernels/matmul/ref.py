"""Plain PyTorch version of the blocked matmul kernel (mirrors the JAX
oracle ``repro.kernels.matmul.ref``)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) with f32 accumulation, result in a.dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)
