"""PowerSGD gradient compression with error feedback [Vogels et al. 2019,
arXiv:1905.13727] (the port of ``repro.train.compression``).

Rank-r compression of each >=2D gradient: G (m,n) ~= P Q^T with P (m,r),
Q (n,r). One power-iteration step per training step:

    P   = G @ Q_prev          ; mean(P)  ; P = orth(P)
    Q   = G^T @ P             ; mean(Q)
    Ghat= P @ Q^T             ; error e = G - Ghat   (fed back next step)

Wire per tensor: r(m+n) floats instead of m*n. The error buffer makes the
scheme unbiased over time. Small tensors (1D norms/biases, or
m*n <= 4*r*(m+n)) sync uncompressed.

The cross-replica means of P and Q go through ``replica_mean`` over the
mesh's batch axes: ``torch.distributed`` all-reduces where the job has
more than one rank, the identity on one (JAX's ``pmean`` over a size-1
axis). Even on one replica the gradient is compressed, with error
feedback, as in the JAX package. The error buffer is each rank's own.

State trees keep the JAX package's keys; a leaf that is not compressed
holds ``None`` in ``q`` and ``err``. The initial Q is drawn from a
``torch.Generator`` (JAX's ``fold_in`` draws cannot be replayed), then
orthonormalised the same way.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.abi import replica_mean
from repro_torch.models.params import tree_map


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """Collapse a >=2D tensor to (leading, rest)."""
    if g.dim() == 2:
        return g
    return g.reshape(g.shape[0], -1)


def _compressible(g, rank: int) -> bool:
    if len(g.shape) < 2:
        return False
    m = g.shape[0]
    size = math.prod(g.shape)
    n = size // m
    return m >= rank and n >= rank and size > 4 * rank * (m + n)


def _unzip(tree, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t: t[i], tree) for i in range(n)]


def powersgd_init(params, rank: int, seed: int = 17) -> dict:
    """Per-leaf state: Q (n, r) random orthonormal-ish, error f32 buffer;
    ``None`` for leaves that sync uncompressed."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def init(p):
        if not _compressible(p, rank):
            return None, None
        q = torch.randn((p.numel() // p.shape[0], rank), generator=gen,
                        dtype=torch.float32)
        q, _ = torch.linalg.qr(q)
        return q.to(p.device), torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)

    qs, errs = _unzip(tree_map(init, params), 2)
    return {"q": qs, "err": errs, "rank": rank}


def powersgd_sync(grads, state: dict, batch_axes, rank: int, mesh=None,
                  abi: str = "host"):
    """Cross-replica mean of grads over ``batch_axes`` of ``mesh`` with
    rank-r compression and error feedback. Returns (synced_grads,
    new_state)."""

    def mean(x):
        return replica_mean(x, batch_axes, mesh, abi)

    def sync(g, q, e):
        if q is None:
            return mean(g.float()).to(g.dtype), None, None
        g32 = g.float() + e
        g2 = _as_matrix(g32)
        p = mean(g2 @ q)                                    # wire: m*r
        p, _ = torch.linalg.qr(p)                           # orthonormalize
        qn = mean(g2.T @ p)                                 # wire: n*r
        ghat = (p @ qn.T).reshape(g.shape)
        return ghat.to(g.dtype), qn, g32 - ghat             # error feedback

    out, qs, errs = _unzip(tree_map(sync, grads, state["q"], state["err"]),
                           3)
    return out, {"q": qs, "err": errs, "rank": rank}
