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

On a mesh with a ``model`` axis (``shardings``: the params'
NamedShardings) a rank holds its model-axis shard G_loc of each gradient,
and the whole (m, n) matrix is compressed, as the JAX package's GSPMD
compresses it, without gathering G. Where the split dim falls in
``_as_matrix``'s (leading, rest) decides the collectives:

* in ``rest`` (the rank holds n/tp of the columns): P = the sum over
  ``model`` of G_loc @ Q_loc, Q_loc the rows of Q that the rank's
  columns index (strided for a stacked (L, D, F) leaf split on F: the
  (D, F) columns flatten row-major); every rank QRs the same whole P;
  Qn_loc = G_loc^T @ P, gathered over ``model`` into the whole Qn;
* in ``leading`` (the rank holds m/tp of the rows): P_loc = G_loc @ Q,
  its rows gathered over ``model`` for the QR, the rank keeping its rows;
  Qn = the sum over ``model`` of G_loc^T @ P_loc.

The batch means come before the model-axis collective (they commute: both
are linear), and the error buffer is the rank's part of the whole
error. Q is whole on every rank of the model axis, as the JAX package's
comm spec (its batch axes on the leading replica axis only) keeps it: a
checkpoint of it needs no layout of strided rows. The model axis moves
(m + n) r floats a leaf, counted under the ABI's label
(``chip_smoke.powersgd_wire_bytes``).
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


def _whole_shape(p, sh) -> tuple[int, ...]:
    """The whole leaf's shape, from this rank's part ``p`` and its
    NamedSharding (``None``: ``p`` is whole)."""
    shape = list(p.shape)
    for dim, parts, _ in (sh.split() if sh is not None else ()):
        shape[dim] *= parts
    return tuple(shape)


def _model_dim(sh) -> int | None:
    """The dim of a leaf that its sharding splits over the ``model`` axis
    (``None``: no such dim, or no sharding)."""
    if sh is None:
        return None
    dims = [d for d, _ in sh.split_axes(("model",))]
    return dims[0] if dims else None


def _q_rows(q: torch.Tensor, shape, dim: int, coord: int,
           parts: int) -> torch.Tensor:
    """The rows of a whole leaf's Q (n, r) that index the columns of
    ``_as_matrix`` held by coordinate ``coord`` of ``parts`` along ``dim``
    (>= 1) of the whole ``shape``: for a split on dim d the rest
    (shape[1:]) flattens row-major, so the rows are ``coord``'s block of
    dim d inside every index of the dims before it."""
    outer = math.prod(shape[1:dim])
    inner = math.prod(shape[dim + 1:])
    k = shape[dim] // parts
    return q.reshape(outer, shape[dim], inner, q.shape[1]).narrow(
        1, coord * k, k).reshape(-1, q.shape[1])


def _rows_into(q: torch.Tensor, blocks: torch.Tensor, shape,
               dim: int) -> torch.Tensor:
    """The inverse of ``_q_rows`` over every coordinate: ``blocks``
    (parts, n/parts, r), coordinate c's rows at ``_q_rows(.., c, ..)``,
    written into ``q`` (n, r)."""
    parts, _, r = blocks.shape
    outer = math.prod(shape[1:dim])
    inner = math.prod(shape[dim + 1:])
    k = shape[dim] // parts
    q.view(outer, parts, k, inner, r).copy_(
        blocks.view(parts, outer, k, inner, r).transpose(0, 1))
    return q


def powersgd_init(params, rank: int, seed: int = 17,
                  shardings=None) -> dict:
    """Per-leaf state: Q (n, r) random orthonormal-ish, error f32 buffer;
    ``None`` for leaves that sync uncompressed. With ``shardings`` (the
    params' NamedShardings on a mesh with a model axis) ``params`` are
    this rank's parts: compressibility and Q come from the whole leaf (the
    same draws as one process), Q is whole and the error buffer is the
    rank's part."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def init(p, sh=None):
        whole = _whole_shape(p, sh)
        if not _compressible(torch.empty(whole, device="meta"), rank):
            return None, None
        q = torch.randn((math.prod(whole) // whole[0], rank), generator=gen,
                        dtype=torch.float32)
        q, _ = torch.linalg.qr(q)
        return q.to(p.device), torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)

    pairs = (tree_map(init, params) if shardings is None
             else tree_map(init, params, shardings))
    qs, errs = _unzip(pairs, 2)
    return {"q": qs, "err": errs, "rank": rank}


def powersgd_sync(grads, state: dict, batch_axes, rank: int, mesh=None,
                  abi: str = "host", shardings=None):
    """Cross-replica mean of grads over ``batch_axes`` of ``mesh`` with
    rank-r compression and error feedback. Returns (synced_grads,
    new_state). With ``shardings`` on a mesh with a ``model`` axis the
    grads are this rank's shards and each compressed leaf's whole matrix
    is compressed (the module docstring)."""
    from repro_torch.dist.mesh import collective
    tp = 1 if mesh is None else mesh.shape.get("model", 1)
    group = mesh.group(("model",)) if tp > 1 else None

    def mean(x):
        return replica_mean(x, batch_axes, mesh, abi)

    def model_sum(x):
        collective(mesh, abi, "all_reduce", x, x, group)
        return x

    def model_gather(x):
        out = torch.empty(tp * x.numel(), dtype=x.dtype, device=x.device)
        collective(mesh, abi, "all_gather", out, x.reshape(-1), group)
        return out.view(tp, *x.shape)

    def sync(g, q, e, sh=None):
        if q is None:
            return mean(g.float()).to(g.dtype), None, None
        g32 = g.float() + e
        g2 = _as_matrix(g32)
        dim = _model_dim(sh) if tp > 1 else None
        if dim is None:
            p = mean(g2 @ q)                                # wire: m*r
            p, _ = torch.linalg.qr(p)                       # orthonormalize
            qn = mean(g2.T @ p)                             # wire: n*r
            ghat = (p @ qn.T).reshape(g.shape)
            return ghat.to(g.dtype), qn, g32 - ghat         # error feedback
        coord = mesh.coords()["model"]
        whole = _whole_shape(g, sh)
        if dim == 0:                                        # rows split
            p_loc = mean(g2 @ q)
            p, _ = torch.linalg.qr(model_gather(p_loc).reshape(-1, rank))
            p_loc = p.reshape(tp, -1, rank)[coord]
            qn = mean(model_sum(g2.T @ p_loc))
            ghat = p_loc @ qn.T
        else:                                               # columns split
            p = mean(model_sum(g2 @ _q_rows(q, whole, dim, coord, tp)))
            p, _ = torch.linalg.qr(p)
            qn_loc = mean(g2.T @ p)
            qn = _rows_into(torch.empty_like(q), model_gather(qn_loc),
                            whole, dim)
            ghat = p @ qn_loc.T
        ghat = ghat.reshape(g.shape)
        return ghat.to(g.dtype), qn, g32 - ghat

    if shardings is None:
        out = tree_map(sync, grads, state["q"], state["err"])
    else:
        out = tree_map(sync, grads, state["q"], state["err"], shardings)
    out, qs, errs = _unzip(out, 3)
    return out, {"q": qs, "err": errs, "rank": rank}
