"""GQA attention: prefill (full + local window) and cached decode.

Geometry, parameter layouts and the mask arithmetic follow
``repro.models.attention``: ``wq`` is (D, n_q, hd), q heads pad to the TP
width and kv heads replicate by gather.

Tensor parallelism (``axis``: the rank's ``dist.sharding.ModelAxis``) is
the reference's padded geometry, computed explicitly: the rank holds
``wq`` as (D, n_q/tp, hd) and ``wo`` as (n_q/tp, hd, D), ``wk``/``wv``
whole (replicated, as ``("embed", None, None)`` keeps them). Every rank
computes all ``n_kv_orig`` kv heads, which then enter the rank's region,
replicates them to ``n_kv`` as the reference does and keeps its
``n_kv/tp`` slots; attention runs on (n_q/tp, n_kv/tp) heads and the
output projection's partial sum is reduced over the axis. Cached decode
on a rank's shard (serving at tp > 1) is not ported and raises.

Kernels
-------
``attend`` is the plain path (``_sdpa_dense``, or ``_sdpa_chunked`` above
``CHUNKED_KV_THRESHOLD`` keys). On a CUDA tensor with more than one query
(prefill, local-window prefill, and the prefix-cached suffix prefill whose
causal offset is ``Sk - Sq = prefix_len``) it calls the flash-attention
forward kernel -- where the JAX package's design puts its Pallas kernel.
Decode over a paged pool goes through the paged-attention kernel
(``paged_decode_attn``). Contiguous slot decode, full or over a window's
ring buffer, keeps the plain path: it ran through XLA, not a Pallas
kernel, in the JAX package too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.dist.mesh import NOT_PORTED
from repro_torch.dist.sharding import (ModelAxis, copy_to_model,
                                       reduce_from_model)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import ParamDef

NEG_INF = -1e30
CHUNKED_KV_THRESHOLD = 8192   # use online-softmax chunks above this many keys
KV_CHUNK = 2048
Q_CHUNK = 2048


@dataclass(frozen=True)
class AttnGeometry:
    n_q: int          # padded q heads
    n_q_orig: int
    n_kv: int         # replicated (and, for MHA, padded) kv heads
    n_kv_orig: int
    head_dim: int

    @property
    def q_per_kv(self) -> int:
        return self.n_q // self.n_kv

    @property
    def kv_rep(self) -> int:
        return self.n_kv // self.n_kv_orig if self.n_kv % self.n_kv_orig == 0 else 0


def resolve_geometry(cfg: ModelConfig, tp: int) -> AttnGeometry:
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    hp = -(-h // tp) * tp if h % tp else h            # pad q heads to TP multiple
    if kv == h:                                        # MHA: kv pads with q
        kvp = hp
    else:
        r = 1
        while r <= tp and ((kv * r) % tp or hp % (kv * r)):
            r += 1
        kvp = kv * r if r <= tp else hp                # fallback: full replication
    return AttnGeometry(hp, h, kvp, kv, hd)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, geom: AttnGeometry) -> dict:
    D, hd = cfg.d_model, geom.head_dim
    return {
        "wq": ParamDef((D, geom.n_q, hd), ("embed", "heads", None)),
        "wk": ParamDef((D, geom.n_kv_orig, hd), ("embed", None, None)),
        "wv": ParamDef((D, geom.n_kv_orig, hd), ("embed", None, None)),
        "wo": ParamDef((geom.n_q, hd, D), ("heads", None, "embed")),
    }


# ---------------------------------------------------------------------------
# score-path helpers (the plain path)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(..., Sq, Sk) additive mask: causal, optionally sliding-window."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    ok &= k_pos[..., None, :] >= 0           # ring-buffer slots not yet written
    if window:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa_dense(q, k, v, q_pos, k_pos, window, scale) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,hd)  k,v: (B,Sk,Hkv,hd)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = s + _mask_bias(q_pos, k_pos, window)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def _sdpa_chunked(q, k, v, q_pos, k_pos, window, scale,
                  score_dtype=torch.float32,
                  q_chunk=None, kv_chunk=None, q_offset: int = 0) -> torch.Tensor:
    """Online softmax over KV chunks; O(Sq * KV_CHUNK) scores instead of
    O(Sq * Sk). Fully-future (and fully out-of-window) chunk pairs are
    skipped, given positions ascending from ``q_offset``."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    kv_c = kv_chunk or KV_CHUNK
    q_c = q_chunk or Q_CHUNK
    nchunks = -(-Sk // kv_c)
    pad = nchunks * kv_c - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad),
                                        value=torch.iinfo(torch.int32).max)
    nq = -(-Sq // q_c)
    qpad = nq * q_c - Sq
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, qpad))
        q_pos = torch.nn.functional.pad(q_pos, (0, qpad), value=-1)

    causal_layout = Sq > 1
    out_qchunks = []
    for qi in range(nq):
        qb = q[:, qi * q_c:(qi + 1) * q_c]
        qpb = q_pos[:, qi * q_c:(qi + 1) * q_c]
        m = torch.full((B, Hkv, G, q_c), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_c), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, q_c, hd), dtype=torch.float32,
                          device=q.device)
        q_lo = q_offset + qi * q_c
        q_hi = q_offset + (qi + 1) * q_c - 1
        for ki in range(nchunks):
            k_lo = ki * kv_c
            if causal_layout:
                if k_lo > q_hi:                   # fully future: skip
                    continue
                if window and (ki + 1) * kv_c - 1 < q_lo - window + 1:
                    continue                      # fully out of window: skip
            kb = k[:, k_lo:k_lo + kv_c]
            vb = v[:, k_lo:k_lo + kv_c]
            pb = k_pos[:, k_lo:k_lo + kv_c]
            if score_dtype == torch.float32:
                s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).float() * scale
                s = s + _mask_bias(qpb, pb, window)[:, None, None]
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                pv = p.to(vb.dtype)
            else:
                s = (torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).to(score_dtype)
                     * torch.tensor(scale, dtype=score_dtype, device=q.device))
                s = s + _mask_bias(qpb, pb, window)[:, None, None].to(score_dtype)
                m_new = torch.maximum(m, s.amax(dim=-1).float())
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None].to(score_dtype))
                l = l * alpha + torch.sum(p, dim=-1, dtype=torch.float32)
                pv = p.to(vb.dtype)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pv, vb).float()
            m = m_new
        out_qchunks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(out_qchunks, dim=3)            # (B,Hkv,G,Sq+pad,hd)
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out[:, :Sq] if qpad else out


def attend(q, k, v, q_pos, k_pos, window: int = 0,
           score_dtype=torch.float32, q_chunk=None, kv_chunk=None,
           q_offset: int = 0) -> torch.Tensor:
    """Grouped attention. q: (B,Sq,Hq,hd) -> (B,Sq,Hq,hd).

    k/v carry the *replicated* kv heads (geom.n_kv). On CUDA with Sq > 1
    and float32 scores the flash-attention kernel runs instead of the
    plain path. It derives its mask from the canonical causal layout alone
    -- q positions ``q_offset + arange(Sq)`` and k positions
    ``arange(Sk)``, one row shared by the batch, ``Sk - Sq == q_offset``
    -- so a call outside that layout (checked by shape, since reading the
    position values would stall the host on the card) raises there rather
    than compute something else. Another ``score_dtype`` is the
    reference's low-precision score chain, which it computes in XLA, not
    in its Pallas kernel: it takes the chunked path here too, chosen by
    dtype before any launch."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    if q.is_cuda and Sq > 1 and score_dtype == torch.float32:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        Sk = k.shape[1]
        if not (Sk - Sq == q_offset and tuple(q_pos.shape) == (1, Sq)
                and tuple(k_pos.shape) == (1, Sk)):
            raise ValueError(
                f"flash prefill needs the canonical causal layout: Sk - Sq == "
                f"q_offset and (1, S) position rows, got Sk={Sk} Sq={Sq} "
                f"q_offset={q_offset} q_pos {tuple(q_pos.shape)} k_pos "
                f"{tuple(k_pos.shape)}")
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window)
        return out.transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    if k.shape[1] > CHUNKED_KV_THRESHOLD or score_dtype != torch.float32:
        out = _sdpa_chunked(qg, k, v, q_pos, k_pos, window, scale,
                            score_dtype, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            q_offset=q_offset)
    else:
        out = _sdpa_dense(qg, k, v, q_pos, k_pos, window, scale)
    return out.reshape(B, Sq, Hq, hd)


# ---------------------------------------------------------------------------
# block forward paths
# ---------------------------------------------------------------------------

def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, geom: AttnGeometry,
                positions: torch.Tensor, axis: ModelAxis | None = None):
    """x: (B,S,D) -> q (B,S,Hq,hd), k/v (B,S,n_kv,hd) with RoPE + replication;
    on a model axis the rank's Hq/tp q heads and n_kv/tp kv slots."""
    q = torch.einsum("bsd,dhk->bshk", copy_to_model(x, axis),
                     p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    k, v = copy_to_model(k, axis), copy_to_model(v, axis)
    k, v = replicate_kv(k, geom, axis), replicate_kv(v, geom, axis)
    return q, k, v


def replicate_kv(kv: torch.Tensor, geom: AttnGeometry,
                 axis: ModelAxis | None = None) -> torch.Tensor:
    """(…, n_kv_orig, hd) -> (…, n_kv, hd), or on a model axis the rank's
    (…, n_kv/tp, hd) slots of it.

    Gather-based replication: target slot j serves padded q heads
    [j*g, (j+1)*g) and reads the kv head the FIRST of those q heads uses in
    the canonical (unpadded) grouping. For divisible cases this equals a
    repeat; for padded MHA the extra slots alias the last canonical head."""
    h = kv.shape[-2]
    n = geom.n_kv // (axis.size if axis is not None else 1)
    first = axis.coord * n if axis is not None else 0
    if h == geom.n_kv:
        return kv if axis is None else kv.narrow(-2, first, n)
    g = geom.q_per_kv
    group = max(1, geom.n_q_orig // h)          # canonical q-heads per kv
    q0 = torch.clamp(torch.arange(first, first + n, device=kv.device) * g,
                     max=geom.n_q_orig - 1)
    idx = torch.clamp(q0 // group, max=h - 1)
    return torch.index_select(kv, kv.dim() - 2, idx)


def attn_out(p: dict, ctx: torch.Tensor,
             axis: ModelAxis | None = None) -> torch.Tensor:
    return reduce_from_model(
        torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype)), axis)


def _whole_heads(p: dict, geom: AttnGeometry) -> None:
    """Cached decode needs every q head: a rank's shard of ``wq`` (serving
    at a model axis above 1) raises."""
    if p["wq"].shape[1] != geom.n_q:
        raise NotImplementedError(
            f"cached decode on {p['wq'].shape[1]} of {geom.n_q} q heads "
            f"(serving at a model axis above 1): {NOT_PORTED}")


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def paged_decode_attn(p: dict, x: torch.Tensor, layer_cache: dict,
                      idx: torch.Tensor, page_table: torch.Tensor,
                      cfg: ModelConfig, geom: AttnGeometry,
                      window: int = 0):
    """One-token decode over a PAGED KV pool (slot-granular only).

    x: (B,1,D); layer_cache k/v: (n_kv, n_pages, page_size, hd) -- the
    layer's global page pool; idx: (B,) per-row positions; page_table:
    (B, max_pages) int32 physical page ids (garbage page 0 where unmapped).

    Writes the new token's K/V IN PLACE into page ``table[b, idx//ps]`` at
    offset ``idx % ps`` (where the JAX package returns a new buffer), then
    attends through ``kernels.paged_attention`` (the CUDA kernel on a card,
    the plain version on the CPU). Free slots write through table rows reset
    to the garbage page -- several at once, in no defined order, which is
    harmless because page 0 is never read unmasked. Returns (out, cache)
    with ``cache`` the same, updated, tensors."""
    if window:
        raise NotImplementedError(
            "paged decode supports full attention only (ring-buffer windows "
            "keep the contiguous per-slot layout)")
    _whole_heads(p, geom)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    positions = idx[:, None].to(torch.int32)
    q, k, v = project_qkv(p, x, cfg, geom, positions)   # k/v: (B,1,n_kv,hd)
    ck, cv = layer_cache["k"], layer_cache["v"]
    n_kv, n_pages, ps, hd = ck.shape
    mp = page_table.shape[1]
    idx_l = idx.long()
    col = torch.clamp(idx_l // ps, 0, mp - 1)
    page = torch.gather(page_table.long(), 1, col[:, None])[:, 0]
    page = torch.clamp(page, 0, n_pages - 1)
    off = idx_l % ps
    ck[:, page, off] = k[:, 0].transpose(0, 1).to(ck.dtype)   # (n_kv, B, hd)
    cv[:, page, off] = v[:, 0].transpose(0, 1).to(cv.dtype)
    ctx = paged_attention(q[:, 0].contiguous(), ck, cv,
                          page_table.to(torch.int32).contiguous(),
                          (idx.to(torch.int32) + 1).contiguous(),
                          window=window)
    return attn_out(p, ctx[:, None]), {"k": ck, "v": cv}


def row_positions(idx, batch: int, device, lockstep: bool = True):
    """A decode position as a (B,) tensor on ``device``: ``idx`` is a
    Python int or a 0-d tensor (a lockstep batch: every row at the same
    position, broadcast without a copy) or a (B,) tensor of per-row
    positions. Only shapes are inspected, never values, so the decode
    stays free of host syncs. ``lockstep=False`` (the paged path, as in
    the JAX package) accepts (B,) only."""
    idx = torch.as_tensor(idx, device=device)
    if idx.dim() == 0 and lockstep:
        return idx.expand(batch)
    if tuple(idx.shape) != (batch,):
        raise ValueError(
            f"decode position of shape {tuple(idx.shape)}: expected "
            + ("() or " if lockstep else "") + f"({batch},)")
    return idx


def decode_attn(p: dict, x: torch.Tensor, layer_cache: dict,
                idx: torch.Tensor, cfg: ModelConfig, geom: AttnGeometry,
                window: int = 0):
    """One-token decode over contiguous per-slot slabs. x: (B,1,D);
    layer_cache k/v: (B,S,n_kv,hd); idx: (B,) per-row positions, as
    ``row_positions`` gives them (a lockstep batch's scalar position is
    broadcast there, once a step). Row b's new K/V is written IN PLACE at
    position idx[b]. Returns (out, cache).

    For ``window`` caches the slab is a ring of S = min(window, max_len)
    slots: position p lives at slot ``p % S``, and the true position of
    slot j, seen from the write at idx, is ``idx - ((idx % S - j) mod S)``
    (negative for slots not written yet, which the mask hides)."""
    _whole_heads(p, geom)
    B = x.shape[0]
    positions = idx[:, None].to(torch.int32)
    q, k, v = project_qkv(p, x, cfg, geom, positions)
    ck, cv = layer_cache["k"], layer_cache["v"]
    S = ck.shape[1]
    idx_l = idx.long()
    slot = torch.remainder(idx_l, S) if window else idx_l
    rows = torch.arange(B, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    ring = torch.arange(S, device=x.device)
    if window:
        k_pos = idx_l[:, None] - torch.remainder(slot[:, None] - ring[None, :], S)
    else:
        k_pos = ring.expand(B, -1)
    ctx = attend(q, ck, cv, positions, k_pos, window,
                 score_dtype=getattr(torch, cfg.attn_score_dtype))
    return attn_out(p, ctx), {"k": ck, "v": cv}
