"""Plain PyTorch version of the paged-attention decode kernel.

Layout contract (shared with ops.py, the CUDA kernel and the PagePool):

  * the KV cache of one layer is a global *page pool*
    ``k_pages/v_pages: (n_kv, n_pages, page_size, head_dim)``;
  * logical position ``p`` of slot ``b`` lives at
    ``(page_table[b, p // page_size], p % page_size)``;
  * page 0 is the pool's reserved *garbage page*: unmapped table entries
    point at it, and the mask (not the allocator) hides the junk;
  * ``lengths[b]`` = number of valid KV positions for slot ``b``.

The arithmetic mirrors the JAX oracle ``repro.kernels.paged_attention.ref``
(same contractions, additive NEG_INF bias, f32 scores), so the paged decode
path reproduces the contiguous slot-decode path token for token.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(n_kv, n_pages, ps, hd) + (B, max_pages) -> contiguous (B, L, n_kv, hd)
    with L = max_pages * ps. Unmapped entries gather the garbage page; page
    ids are clamped into the pool, as jax's gather clamps them."""
    n_kv, n_pages, ps, hd = pages.shape
    B, mp = page_table.shape
    idx = page_table.long().clamp(0, n_pages - 1)
    g = pages[:, idx]                          # (n_kv, B, mp, ps, hd)
    return g.reshape(n_kv, B, mp * ps, hd).permute(1, 2, 0, 3)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor, *, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """One decode tick of attention over paged KV.

    q: (B, Hq, hd) -- one query token per slot;
    k_pages/v_pages: (n_kv, n_pages, page_size, hd);
    page_table: (B, max_pages) int32; lengths: (B,) int32.
    Returns (B, Hq, hd).
    """
    n_kv, _, ps, hd = k_pages.shape
    B, Hq, _ = q.shape
    g = Hq // n_kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k = gather_pages(k_pages, page_table)          # (B, L, n_kv, hd)
    v = gather_pages(v_pages, page_table)
    L = k.shape[1]

    qg = q.reshape(B, 1, n_kv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    k_pos = torch.arange(L, device=q.device).expand(B, L)
    q_pos = (lengths.long() - 1)[:, None]
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        ok &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    bias = torch.where(ok, 0.0, NEG_INF).float()
    s = s + bias[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)  # (B,1,n_kv,g,hd)
    return out.reshape(B, Hq, hd).to(q.dtype)
