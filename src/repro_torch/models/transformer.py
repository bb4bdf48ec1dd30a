"""Decoder-only LM assembly (dense GQA blocks).

Layers are grouped into *stages* exactly as in ``repro.models.transformer``
(each stage a stack of identical *units*, its params stacked on a leading
(L, ...) axis), so parameter and cache trees line up with the JAX
package's leaf for leaf. Where the JAX package scans over the stacked
params, the port runs a Python ``for`` over the layer axis.

Block kinds: ``attn`` (full attention + MLP). The other kinds of the zoo
are not ported yet and raise ``NotImplementedError`` naming their
ROADMAP.md item: ``moe``, ``ssm``, ``rec`` and ``local`` (Queue 1 item 10,
other model families), as do frontend embeddings (same item).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnGeometry, resolve_geometry
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_defs,
    embed_tokens,
    lm_logits,
    mlp_defs,
    norm_defs,
)
from repro_torch.models.params import ParamDef, stack_defs, tree_map

_NOT_PORTED = ("block kind {!r} is not ported yet (ROADMAP.md Queue 1 "
               "item 10: other model families)")


@dataclass(frozen=True)
class Stage:
    unit: tuple[str, ...]     # block kinds within one stacked unit
    count: int                # number of units stacked


def build_stages(cfg: ModelConfig) -> tuple[Stage, ...]:
    types = cfg.layer_types()
    if len(set(types)) == 1:
        return (Stage((types[0],), len(types)),)
    if cfg.block_pattern:
        p = len(cfg.block_pattern)
        n_full, rem = divmod(len(types), p)
        stages = [Stage(tuple(cfg.block_pattern), n_full)] if n_full else []
        if rem:
            stages.append(Stage(tuple(types[n_full * p:]), 1))
        return tuple(stages)
    # run-length group consecutive identical types (first_k_dense etc.)
    stages: list[Stage] = []
    i = 0
    while i < len(types):
        j = i
        while j < len(types) and types[j] == types[i]:
            j += 1
        stages.append(Stage((types[i],), j - i))
        i = j
    if len(stages) > 6:
        raise ValueError(
            f"{cfg.name}: layer pattern fragments into {len(stages)} stages; "
            "set block_pattern explicitly for cyclic layouts"
        )
    return tuple(stages)


def _check_ported(kind: str, cfg: ModelConfig) -> None:
    if kind != "attn":
        raise NotImplementedError(_NOT_PORTED.format(kind))
    if cfg.attn_kind == "local" and cfg.window:
        raise NotImplementedError(_NOT_PORTED.format("local"))


# ---------------------------------------------------------------------------
# per-block param defs
# ---------------------------------------------------------------------------

def block_defs(kind: str, cfg: ModelConfig, geom: AttnGeometry) -> dict:
    _check_ported(kind, cfg)
    d = {"ln1": norm_defs(cfg), "attn": attn_mod.attn_defs(cfg, geom)}
    if not cfg.parallel_block:
        d["ln2"] = norm_defs(cfg)
    d["mlp"] = mlp_defs(cfg)
    return d


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Model:
    """A config bound to a TP width (1 on one card: no head padding)."""

    def __init__(self, cfg: ModelConfig, tp: int = 1,
                 act_dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.geom = resolve_geometry(cfg, tp) if cfg.n_heads else None
        self.stages = build_stages(cfg)
        for st in self.stages:
            for kind in st.unit:
                _check_ported(kind, cfg)
        self.act_dtype = act_dtype

    # -- params ---------------------------------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        d: dict = {"embed": embed_defs(cfg), "final_norm": norm_defs(cfg)}
        for si, st in enumerate(self.stages):
            unit = {
                f"b{bi}": block_defs(kind, cfg, self.geom)
                for bi, kind in enumerate(st.unit)
            }
            d[f"stage{si}"] = stack_defs(unit, st.count)
        return d

    # -- caches -----------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int) -> dict:
        """Contiguous per-slot KV slabs: per attention layer (batch,
        max_len, n_kv, hd), stacked over the stage's layers."""
        g = self.geom
        spec = ("batch", "kv_seq", "kv_heads", None)
        d: dict = {}
        for si, st in enumerate(self.stages):
            d[f"stage{si}"] = {
                f"b{bi}": stack_defs({
                    "k": ParamDef((batch, max_len, g.n_kv, g.head_dim), spec,
                                  "zeros"),
                    "v": ParamDef((batch, max_len, g.n_kv, g.head_dim), spec,
                                  "zeros"),
                }, st.count)
                for bi, _ in enumerate(st.unit)}
        return d

    def paged_cache_defs(self, n_pages: int, page_size: int) -> dict:
        """Cache defs for PAGED serving: per attention layer one global page
        pool ``(n_kv, n_pages, page_size, hd)`` shared by every slot through
        the host-side page table (one table for all layers)."""
        g = self.geom
        spec = ("kv_heads", None, None, None)
        d: dict = {}
        for si, st in enumerate(self.stages):
            d[f"stage{si}"] = {
                f"b{bi}": stack_defs({
                    "k": ParamDef((g.n_kv, n_pages, page_size, g.head_dim),
                                  spec, "zeros"),
                    "v": ParamDef((g.n_kv, n_pages, page_size, g.head_dim),
                                  spec, "zeros"),
                }, st.count)
                for bi, _ in enumerate(st.unit)}
        return d

    # -- forward (prefill) ----------------------------------------------------
    def forward(self, params: dict, tokens: torch.Tensor,
                frontend_embeds: torch.Tensor | None = None,
                frontend_len=None,
                collect_cache: bool = False, cache_len: int | None = None,
                prefix_kv: dict | None = None,
                prefix_pages: torch.Tensor | None = None,
                prefix_len: int = 0):
        """tokens: (B, S_tok). Returns (logits (B,S,Vp), aux) or, with
        ``collect_cache``, (logits, cache, aux).

        SUFFIX prefill over a shared KV prefix: with ``prefix_len > 0``,
        ``tokens`` are only the uncached suffix of a prompt whose first
        ``prefix_len`` positions sit in the paged pool ``prefix_kv`` at the
        physical pages ``prefix_pages`` ((ceil(prefix_len / page_size),)
        int; the last page may be only partly covered). Token positions are
        offset past the prefix, every attention block attends over
        [prefix, suffix], and the collected cache covers the suffix only."""
        cfg = self.cfg
        if frontend_embeds is not None or frontend_len is not None:
            raise NotImplementedError(
                "frontend embeddings are not ported yet (ROADMAP.md Queue 1 "
                "item 10: other model families)")
        if prefix_len and (prefix_kv is None or prefix_pages is None):
            raise ValueError("prefix_len > 0 needs prefix_kv + prefix_pages")
        x = embed_tokens(params["embed"], tokens, cfg, self.act_dtype)
        B, S, _ = x.shape
        positions = prefix_len + torch.arange(
            S, dtype=torch.int32, device=x.device)[None, :]

        caches = {}
        for si, st in enumerate(self.stages):
            sp = params[f"stage{si}"]
            spk = prefix_kv[f"stage{si}"] if prefix_len else None
            layer_entries = []
            for li in range(st.count):
                unit_params = tree_map(lambda a: a[li], sp)
                unit_prefix = (tree_map(lambda a: a[li], spk)
                               if spk is not None else None)
                entries = {}
                for bi, kind in enumerate(st.unit):
                    pkv = unit_prefix.get(f"b{bi}") if unit_prefix else None
                    x, entry = self._apply_block(
                        kind, unit_params[f"b{bi}"], x, positions,
                        collect_cache, cache_len or S, prefix_kv=pkv,
                        prefix_pages=prefix_pages, prefix_len=prefix_len)
                    if collect_cache:
                        entries[f"b{bi}"] = entry
                layer_entries.append(entries)
            if collect_cache:
                caches[f"stage{si}"] = tree_map(
                    lambda *xs: torch.stack(xs), *layer_entries)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params["embed"], x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if collect_cache:
            return logits, caches, aux
        return logits, aux

    def _apply_block(self, kind: str, p: dict, x, positions,
                     collect_cache: bool, cache_len: int,
                     prefix_kv=None, prefix_pages=None, prefix_len: int = 0):
        cfg, geom = self.cfg, self.geom
        _check_ported(kind, cfg)
        entry = None
        h = apply_norm(p["ln1"], x, cfg.norm)
        q, k, v = attn_mod.project_qkv(p["attn"], h, cfg, geom, positions)
        k_all, v_all, kv_pos = k, v, positions
        if prefix_len:
            # gather the cached prefix pages (n_kv, kp, ps, hd) into a
            # contiguous (B, prefix_len, n_kv, hd) history ahead of the
            # suffix KV; prefix_len may end MID-page: the last page is
            # gathered whole and the positions past prefix_len sliced off
            B = k.shape[0]
            pages = prefix_pages.long()

            def _gather(pool):
                n_kv, _, _, hd = pool.shape
                pg = pool[:, pages].reshape(n_kv, -1, hd)[:, :prefix_len]
                return pg.transpose(0, 1)[None].expand(B, prefix_len, n_kv, hd)

            k_all = torch.cat([_gather(prefix_kv["k"]).to(k.dtype), k], dim=1)
            v_all = torch.cat([_gather(prefix_kv["v"]).to(v.dtype), v], dim=1)
            kv_pos = torch.arange(prefix_len + k.shape[1], dtype=torch.int32,
                                  device=x.device)[None, :]
        ctx = attn_mod.attend(q, k_all, v_all, positions, kv_pos, 0,
                              score_dtype=getattr(torch, cfg.attn_score_dtype),
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk,
                              q_offset=prefix_len)
        out = attn_mod.attn_out(p["attn"], ctx)
        if collect_cache:
            entry = self._prefill_cache_entry(k, v, cache_len)
        if cfg.parallel_block:
            x = x + out + apply_mlp(p["mlp"], h, cfg.mlp)
        else:
            x = x + out
            h2 = apply_norm(p["ln2"], x, cfg.norm)
            x = x + apply_mlp(p["mlp"], h2, cfg.mlp)
        return x, entry

    def _prefill_cache_entry(self, k, v, cache_len: int):
        """Store the first ``cache_len`` positions into the cache, right-
        padded with zeros when the prompt is shorter."""
        S = k.shape[1]
        if S >= cache_len:
            return {"k": k[:, S - cache_len:], "v": v[:, S - cache_len:]}
        pad = (0, 0, 0, 0, 0, cache_len - S)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}

    # -- decode ------------------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    idx, page_table: torch.Tensor | None = None):
        """tokens: (B,1); idx: (B,) tensor of per-row positions.
        -> (logits (B,1,Vp), cache).

        With ``page_table`` (B, max_pages) the attention caches are PAGED
        pools (see paged_cache_defs) and decode routes through the paged
        kernel; without it they are contiguous per-slot slabs. Either way
        the cache is updated IN PLACE (per-layer views of the stacked
        tensors) and returned."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg, self.act_dtype)
        for si, st in enumerate(self.stages):
            sp = params[f"stage{si}"]
            sc = cache[f"stage{si}"]
            for li in range(st.count):
                unit_params = tree_map(lambda a: a[li], sp)
                unit_cache = tree_map(lambda a: a[li], sc)
                for bi, kind in enumerate(st.unit):
                    _check_ported(kind, cfg)
                    p = unit_params[f"b{bi}"]
                    c = unit_cache[f"b{bi}"]
                    h = apply_norm(p["ln1"], x, cfg.norm)
                    if page_table is not None:
                        out, _ = attn_mod.paged_decode_attn(
                            p["attn"], h, c, idx, page_table, cfg,
                            self.geom, 0)
                    else:
                        out, _ = attn_mod.decode_attn(p["attn"], h, c, idx,
                                                      cfg, self.geom, 0)
                    if cfg.parallel_block:
                        x = x + out + apply_mlp(p["mlp"], h, cfg.mlp)
                    else:
                        x = x + out
                        h2 = apply_norm(p["ln2"], x, cfg.norm)
                        x = x + apply_mlp(p["mlp"], h2, cfg.mlp)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params["embed"], x, cfg)
        return logits, cache
