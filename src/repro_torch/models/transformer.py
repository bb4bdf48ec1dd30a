"""Decoder-only LM assembly.

Layers are grouped into *stages* exactly as in ``repro.models.transformer``
(each stage a stack of identical *units*, its params stacked on a leading
(L, ...) axis; recurrentgemma's cycle (rec, rec, attn) is one unit of three
blocks), so parameter and cache trees line up with the JAX package's leaf
for leaf. Where the JAX package scans over the stacked params, the port
runs a Python ``for`` over the layer axis.

Training may recompute activations in the backward pass (``remat``): the
JAX package wraps each scanned unit in ``jax.checkpoint``, the port wraps
each unit's body in ``torch.utils.checkpoint`` (``full``: keep only the
unit's input; ``dots``: also keep the outputs of matrix products without
batch dimensions, as ``dots_with_no_batch_dims_saveable``). It applies
only where autograd records the forward.

Block kinds: ``attn`` (full or local-window attention + MLP; a local
window keeps a ring-buffer cache), ``moe`` (attention + routed MoE),
``ssm`` (Mamba-2 SSD) and ``rec`` (RG-LRU + MLP). Frontend archs
(musicgen, internvl2) prepend a modality prefix of embeddings to the
tokens in ``forward``.

Tensor parallelism: a ``Model`` given its mesh's ``ModelAxis`` (the
``model`` group and this rank's coordinate) runs on the rank's shards of
the params -- heads, MLP columns, vocabulary and experts split over the
axis as the JAX package's specs split them -- and places the collectives
GSPMD inserts there (``dist.sharding``); ``moe`` blocks switch to the
expert-parallel ``moe_forward_spmd`` as the JAX package's ``_moe`` does
when it has a mesh; ``ssm`` and ``rec`` blocks run their ``rnn`` and
``heads`` shards (``ssm.py``, ``rglru.py``). ``forward`` and
``decode_step`` return the rank's vocab slice of the logits. Serving runs
on the same shards: a collected or prefixed cache and every decode hold
the rank's part of the reference's cache (its ``kv_heads`` block of the
KV slabs and page pools, its ``rnn`` and ``heads`` blocks of the
recurrent tails and states).

Weight FSDP: a ``Model`` whose ``fsdp`` is an ``FSDP``
(``dist.sharding``) runs on the rank's parts of the leaves it splits
over the batch axes, and gathers them where they are read: each layer's
at the start of its unit,
inside the remat region (``remat=full|dots`` gathers again when the
backward recomputes the unit, so no whole stack stays alive), the
embedding (and tied head) and ``final_norm`` once a forward or decode
step. A serving step runs from FSDP parts on the rank's rows of the
batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.dist.sharding import FSDP, ModelAxis, Replicas
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
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
from repro_torch.models.params import (ParamDef, stack_defs, tree_leaves,
                                      tree_map)

REMAT_MODES = ("none", "full", "dots")


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


def _window(kind: str, cfg: ModelConfig) -> int:
    """The attention window of a block: local-window blocks (a ``local``
    kind, or any attention of an ``attn_kind="local"`` arch) keep a ring
    of ``cfg.window`` positions; 0 is full attention."""
    return cfg.window if (kind == "local" or cfg.attn_kind == "local") else 0


# ---------------------------------------------------------------------------
# per-block param defs
# ---------------------------------------------------------------------------

def block_defs(kind: str, cfg: ModelConfig, geom: AttnGeometry) -> dict:
    if kind in ("attn", "local"):
        d = {"ln1": norm_defs(cfg), "attn": attn_mod.attn_defs(cfg, geom)}
        if not cfg.parallel_block:
            d["ln2"] = norm_defs(cfg)
        d["mlp"] = mlp_defs(cfg)
        return d
    if kind == "moe":
        return {
            "ln1": norm_defs(cfg),
            "attn": attn_mod.attn_defs(cfg, geom),
            "ln2": norm_defs(cfg),
            "moe": moe_mod.moe_defs(cfg),
        }
    if kind == "ssm":
        return {"ln1": norm_defs(cfg), "ssm": ssm_mod.ssm_defs(cfg)}
    if kind == "rec":
        return {
            "ln1": norm_defs(cfg),
            "rec": rec_mod.rec_defs(cfg),
            "ln2": norm_defs(cfg),
            "mlp": mlp_defs(cfg),
        }
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Model:
    """A config bound to a TP width (head padding and kv replication).
    With ``axis`` (the mesh's ``ModelAxis``, of size ``tp``) it runs one
    rank's shards; without it, the whole model in one process, at the
    padded geometry of ``tp``."""

    def __init__(self, cfg: ModelConfig, tp: int = 1,
                 act_dtype: torch.dtype = torch.bfloat16,
                 remat: str = "none", axis: ModelAxis | None = None,
                 moe_impl: str = "spmd"):
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}; expected one "
                             f"of {REMAT_MODES}")
        self.cfg = cfg
        self.geom = resolve_geometry(cfg, tp) if cfg.n_heads else None
        self.stages = build_stages(cfg)
        self.act_dtype = act_dtype
        self.remat = remat
        if axis is not None and axis.size != tp:
            raise ValueError(f"a model axis of {axis.size} ranks for a "
                             f"model bound to tp={tp}")
        self.axis = axis
        # weight FSDP: the Container sets it from the param shardings,
        # which it reads off this model's param defs
        self.fsdp: FSDP | None = None
        self.moe_impl = moe_impl

    def moe_replicas(self, replicas: Replicas | None) -> Replicas | None:
        """The replicas the MoE dispatch of a call runs over when the
        call's rows are this rank's block of a batch split over
        ``replicas``: all of them where the reference's ``moe_forward``
        sees the global batch under GSPMD -- an MoE arch whose
        expert-parallel region does not run (``model`` at 1, ``moe_impl``
        not ``spmd``, or a model axis that does not divide the experts);
        else ``None``, the call's own rows."""
        if self.cfg.n_experts and replicas is not None and (
                self.axis is None or self.moe_impl != "spmd"
                or self.cfg.n_experts % self.axis.size):
            return replicas
        return None

    # -- params ---------------------------------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        d: dict = {"embed": embed_defs(cfg), "final_norm": norm_defs(cfg)}
        for si, st in enumerate(self.stages):
            d[f"stage{si}"] = stack_defs(self.unit_param_defs(si), st.count)
        return d

    # -- caches -----------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int) -> dict:
        """Contiguous per-slot caches, stacked over each stage's layers: KV
        slabs (batch, S, n_kv, hd) with S = max_len, or the ring
        min(window, max_len) for local attention; conv tails and recurrent
        states for ``ssm`` and ``rec`` blocks."""
        return {f"stage{si}": stack_defs(
                    self.unit_cache_defs(si, batch, max_len), st.count)
                for si, st in enumerate(self.stages)}

    def _block_cache_defs(self, kind: str, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if kind in ("attn", "local", "moe"):
            g = self.geom
            window = _window(kind, cfg)
            S = min(window, max_len) if window else max_len
            spec = ("batch", "kv_seq", "kv_heads", None)
            return {
                "k": ParamDef((batch, S, g.n_kv, g.head_dim), spec, "zeros"),
                "v": ParamDef((batch, S, g.n_kv, g.head_dim), spec, "zeros"),
            }
        if kind == "ssm":
            di, ds = cfg.d_inner, cfg.ssm_state
            return {
                "conv": ParamDef((batch, cfg.conv_kernel - 1, di + 2 * ds),
                                 ("batch", None, "rnn"), "zeros"),
                "state": ParamDef((batch, cfg.ssm_heads, ds, cfg.ssm_headdim),
                                  ("batch", "heads", None, None), "zeros"),
            }
        R = cfg.rnn_width_                                    # rec
        return {
            "conv": ParamDef((batch, cfg.conv_kernel - 1, R),
                             ("batch", None, "rnn"), "zeros"),
            "state": ParamDef((batch, R), ("batch", "rnn"), "zeros"),
        }

    def paged_cache_defs(self, n_pages: int, page_size: int) -> dict:
        """Cache defs for PAGED serving: per attention layer one global page
        pool ``(n_kv, n_pages, page_size, hd)`` shared by every slot through
        the host-side page table (one table for all layers). Ring-buffer
        (windowed) and recurrent caches are per-slot state, not pageable
        history: they raise."""
        cfg = self.cfg
        if cfg.attn_kind == "local" and cfg.window:
            raise NotImplementedError(
                "paged KV cache does not support sliding-window attention "
                "(ring-buffer caches stay contiguous)")
        g = self.geom
        spec = ("kv_heads", None, None, None)
        d: dict = {}
        for si, st in enumerate(self.stages):
            unit: dict = {}
            for bi, kind in enumerate(st.unit):
                if kind in ("ssm", "rec", "local"):
                    raise NotImplementedError(
                        f"paged KV cache does not support {kind!r} blocks "
                        "(windowed/recurrent caches stay contiguous)")
                unit[f"b{bi}"] = stack_defs({
                    "k": ParamDef((g.n_kv, n_pages, page_size, g.head_dim),
                                  spec, "zeros"),
                    "v": ParamDef((g.n_kv, n_pages, page_size, g.head_dim),
                                  spec, "zeros"),
                }, st.count)
            d[f"stage{si}"] = unit
        return d

    # -- forward (prefill) ----------------------------------------------------
    def forward(self, params: dict, tokens: torch.Tensor,
                frontend_embeds: torch.Tensor | None = None,
                frontend_len=None,
                collect_cache: bool = False, cache_len: int | None = None,
                prefix_kv: dict | None = None,
                prefix_pages: torch.Tensor | None = None,
                prefix_len: int = 0, replicas: Replicas | None = None):
        """tokens: (B, S_tok). Returns (logits (B,S,Vp), aux) or, with
        ``collect_cache``, (logits, cache, aux); ``aux`` sums the MoE
        blocks' load-balancing losses (0 without MoE).

        ``frontend_embeds`` (B, F, D) is a modality prefix prepended ahead
        of the token embeddings. ``frontend_len`` (scalar or (B,)) marks how
        many of the F rows are real: the prefix and tokens are then packed
        contiguously (real frontend rows, then tokens, then the right-pad
        rows, clamped), so positions stay gap-free and the causal mask
        hides every pad row. With ``frontend_len == F`` the pack is the
        identity gather.

        SUFFIX prefill over a shared KV prefix: with ``prefix_len > 0``,
        ``tokens`` are only the uncached suffix of a prompt whose first
        ``prefix_len`` positions sit in the paged pool ``prefix_kv`` at the
        physical pages ``prefix_pages`` ((ceil(prefix_len / page_size),)
        int; the last page may be only partly covered). Token positions are
        offset past the prefix, every attention block attends over
        [prefix, suffix], and the collected cache covers the suffix only.

        ``replicas``: the rows are this rank's block of a batch split over
        them (a train step's or a slot bank's), for the MoE dispatch
        (``moe_replicas``)."""
        cfg = self.cfg
        if prefix_len:
            if frontend_embeds is not None:
                raise NotImplementedError(
                    "prefix-cached suffix prefill does not compose with "
                    "frontend embeddings")
            if prefix_kv is None or prefix_pages is None:
                raise ValueError("prefix_len > 0 needs prefix_kv + "
                                 "prefix_pages")
        fsdp = self.fsdp
        params = self._outer_whole(params)
        x = embed_tokens(params["embed"], tokens, cfg, self.act_dtype,
                         self.axis)
        if frontend_embeds is not None:
            fe = frontend_embeds.to(device=x.device, dtype=self.act_dtype)
            x = torch.cat([fe, x], dim=1)
            if frontend_len is not None:
                F, S = fe.shape[1], x.shape[1]
                fl = torch.as_tensor(frontend_len, dtype=torch.int64,
                                     device=x.device)
                fl = fl.reshape(-1).expand(x.shape[0])[:, None]
                pos = torch.arange(S, device=x.device)[None, :]
                src = torch.where(pos < fl, pos, pos + (F - fl))
                src = torch.clamp(src, max=S - 1)   # tail rows: clamped pad
                x = torch.gather(x, 1, src[:, :, None].expand(-1, -1,
                                                              x.shape[2]))
        B, S, _ = x.shape
        positions = prefix_len + torch.arange(
            S, dtype=torch.int32, device=x.device)[None, :]

        caches = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_reps = self.moe_replicas(replicas)
        unit = self._unit
        if (self.remat != "none" and torch.is_grad_enabled()
                and not collect_cache):
            unit = _remat(unit, self.remat)
        for si, st in enumerate(self.stages):
            # a layer's params as views of the stacked leaves; unbind makes
            # their backward one stack of the layers' grads, where indexing
            # would write each layer's grad into a zero-filled full leaf
            sp = tree_map(torch.unbind, params[f"stage{si}"])
            spk = prefix_kv[f"stage{si}"] if prefix_len else None
            unit_fsdp = fsdp.layer(f"stage{si}") if fsdp else None
            layer_entries = []
            for li in range(st.count):
                unit_params = tree_map(lambda a: a[li], sp)
                unit_prefix = (tree_map(lambda a: a[li], spk)
                               if spk is not None else None)
                x, aux, entries = unit(
                    st, unit_params, x, aux, positions, collect_cache,
                    cache_len or S, unit_prefix, prefix_pages, prefix_len,
                    unit_fsdp, moe_reps)
                layer_entries.append(entries)
            if collect_cache:
                caches[f"stage{si}"] = tree_map(
                    lambda *xs: torch.stack(xs), *layer_entries)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params["embed"], x, cfg, self.axis)
        if collect_cache:
            return logits, caches, aux
        return logits, aux

    def _outer_whole(self, params: dict) -> dict:
        """``params`` with the embedding (and tied head) and
        ``final_norm`` gathered whole under FSDP, once a forward or decode
        step; as they are without it."""
        fsdp = self.fsdp
        if fsdp is None:
            return params
        return {**params, **{k: fsdp.gather(params[k], fsdp.shardings[k])
                             for k in ("embed", "final_norm")}}

    def _unit(self, st: Stage, unit_params: dict, x, aux, positions,
              collect_cache: bool, cache_len: int, unit_prefix=None,
              prefix_pages=None, prefix_len: int = 0, unit_fsdp=None,
              moe_reps: Replicas | None = None):
        """One stacked unit's blocks (the JAX package's scan body) ->
        (x, aux, the blocks' cache entries). Under FSDP (``unit_fsdp``:
        the layer's shardings) its params are gathered first, inside the
        remat region."""
        if unit_fsdp is not None:
            unit_params = self.fsdp.gather(unit_params, unit_fsdp)
        entries = {}
        for bi, kind in enumerate(st.unit):
            pkv = unit_prefix.get(f"b{bi}") if unit_prefix else None
            x, aux_b, entry = self._apply_block(
                kind, unit_params[f"b{bi}"], x, positions, collect_cache,
                cache_len, prefix_kv=pkv, prefix_pages=prefix_pages,
                prefix_len=prefix_len, moe_reps=moe_reps)
            if aux_b is not None:
                aux = aux + aux_b
            if collect_cache:
                entries[f"b{bi}"] = entry
        return x, aux, entries

    def _apply_block(self, kind: str, p: dict, x, positions,
                     collect_cache: bool, cache_len: int,
                     prefix_kv=None, prefix_pages=None, prefix_len: int = 0,
                     moe_reps: Replicas | None = None):
        """One block's prefill -> (x, aux or None, cache entry or None);
        ``aux`` is the MoE load-balancing loss of a ``moe`` block."""
        cfg, geom = self.cfg, self.geom
        entry = None
        window = _window(kind, cfg)
        if prefix_len and (window or kind in ("ssm", "rec")):
            raise NotImplementedError(
                "prefix-cached suffix prefill supports full attention only")
        axis = self.axis
        if kind == "ssm":
            h = apply_norm(p["ln1"], x, cfg.norm)
            if collect_cache:
                out, entry = ssm_mod.ssm_forward(p["ssm"], h, cfg,
                                                 return_cache=True,
                                                 axis=axis)
            else:
                out = ssm_mod.ssm_forward(p["ssm"], h, cfg, axis=axis)
            return x + out, None, entry
        if kind == "rec":
            h = apply_norm(p["ln1"], x, cfg.norm)
            if collect_cache:
                out, entry = rec_mod.rec_forward(p["rec"], h, cfg,
                                                 return_cache=True,
                                                 axis=axis)
            else:
                out = rec_mod.rec_forward(p["rec"], h, cfg, axis=axis)
            x = x + out
            h2 = apply_norm(p["ln2"], x, cfg.norm)
            return x + apply_mlp(p["mlp"], h2, cfg.mlp, axis), None, entry
        h = apply_norm(p["ln1"], x, cfg.norm)
        q, k, v = attn_mod.project_qkv(p["attn"], h, cfg, geom, positions,
                                       axis)
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
        ctx = attn_mod.attend(q, k_all, v_all, positions, kv_pos, window,
                              score_dtype=getattr(torch, cfg.attn_score_dtype),
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk,
                              q_offset=prefix_len)
        out = attn_mod.attn_out(p["attn"], ctx, axis)
        if collect_cache:
            entry = self._prefill_cache_entry(k, v, window, cache_len)
        aux = None
        if cfg.parallel_block:
            x = x + out + apply_mlp(p["mlp"], h, cfg.mlp, axis)
        else:
            x = x + out
            h2 = apply_norm(p["ln2"], x, cfg.norm)
            if kind == "moe":
                moe_out, aux = self._moe(p["moe"], h2, moe_reps)
                x = x + moe_out
            else:
                x = x + apply_mlp(p["mlp"], h2, cfg.mlp, axis)
        return x, aux, entry

    def _moe(self, p_moe, h, replicas: Replicas | None = None):
        """The MoE block: expert-parallel on a model axis, as the JAX
        package's ``_moe`` switches to ``moe_forward_spmd`` with a mesh;
        over the global batch of ``replicas`` (``moe_replicas``)."""
        if self.axis is not None:
            return moe_mod.moe_forward_spmd(p_moe, h, self.cfg, self.axis,
                                            replicas)
        return moe_mod.moe_forward(p_moe, h, self.cfg, replicas)

    def _prefill_cache_entry(self, k, v, window: int, cache_len: int):
        """Store the last ``cache_len`` (or window) positions into the cache,
        right-padded with zeros when the prompt is shorter.

        Windowed caches are *ring buffers* with the invariant that position p
        lives at slot ``p % ring``; the kept tail is rolled into that layout
        or the first decoded tokens attend to permuted history."""
        S = k.shape[1]
        keep = min(window, cache_len) if window else cache_len
        if S >= keep:
            k_, v_ = k[:, S - keep:], v[:, S - keep:]
            if window:
                k_ = torch.roll(k_, S % keep, dims=1)
                v_ = torch.roll(v_, S % keep, dims=1)
            return {"k": k_, "v": v_}
        pad = (0, 0, 0, 0, 0, keep - S)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}

    # -- decode ------------------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    idx, page_table: torch.Tensor | None = None,
                    replicas: Replicas | None = None):
        """tokens: (B,1); idx: position -- a Python int or 0-d tensor
        (lockstep batch) or a (B,) tensor of per-row positions
        (slot-granular continuous batching); normalised once, on the
        device, to (B,) (``attention.row_positions``).
        -> (logits (B,1,Vp), cache).

        With ``page_table`` (B, max_pages) the attention caches are PAGED
        pools (see paged_cache_defs) and decode routes through the paged
        kernel, with (B,) positions only, as in the JAX package; without
        it they are contiguous per-slot slabs. Either way the cache is
        updated IN PLACE (per-layer views of the stacked tensors; a
        recurrent block's new conv tail and state are copied into them,
        cast to the cache's dtype) and returned.

        On a model axis the cache is the rank's part and the logits its
        vocab slice; under FSDP the embedding, ``final_norm`` and each
        layer's parts are gathered where they are read, as in
        ``forward``; ``replicas`` as in ``forward``."""
        cfg = self.cfg
        fsdp, axis = self.fsdp, self.axis
        moe_reps = self.moe_replicas(replicas)
        params = self._outer_whole(params)
        x = embed_tokens(params["embed"], tokens, cfg, self.act_dtype, axis)
        idx = attn_mod.row_positions(idx, tokens.shape[0], x.device,
                                     lockstep=page_table is None)
        for si, st in enumerate(self.stages):
            sp = params[f"stage{si}"]
            sc = cache[f"stage{si}"]
            unit_fsdp = fsdp.layer(f"stage{si}") if fsdp else None
            for li in range(st.count):
                x = self._decode_unit(st, tree_map(lambda a: a[li], sp),
                                      tree_map(lambda a: a[li], sc), x, idx,
                                      page_table, unit_fsdp, moe_reps)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params["embed"], x, cfg, axis)
        return logits, cache

    def _decode_unit(self, st: Stage, unit_params: dict, unit_cache: dict,
                     x, idx, page_table, unit_fsdp=None, moe_reps=None):
        """One stacked unit's one-token decode (its params gathered first
        under FSDP), its cache views updated in place -> x."""
        if unit_fsdp is not None:
            unit_params = self.fsdp.gather(unit_params, unit_fsdp)
        for bi, kind in enumerate(st.unit):
            x = self._decode_block(kind, unit_params[f"b{bi}"],
                                   unit_cache[f"b{bi}"], x, idx, page_table,
                                   moe_reps)
        return x

    def _decode_block(self, kind: str, p: dict, c: dict, x, idx, page_table,
                      moe_reps=None):
        cfg, axis = self.cfg, self.axis
        h = apply_norm(p["ln1"], x, cfg.norm)
        if kind == "ssm":
            out, new = ssm_mod.ssm_decode(p["ssm"], h, c, cfg, axis)
            _write_state(c, new)
            return x + out
        if kind == "rec":
            out, new = rec_mod.rec_decode(p["rec"], h, c, cfg, axis)
            _write_state(c, new)
            x = x + out
            h2 = apply_norm(p["ln2"], x, cfg.norm)
            return x + apply_mlp(p["mlp"], h2, cfg.mlp, axis)
        window = _window(kind, cfg)
        if page_table is not None:
            out, _ = attn_mod.paged_decode_attn(
                p["attn"], h, c, idx, page_table, cfg, self.geom, window,
                axis)
        else:
            out, _ = attn_mod.decode_attn(p["attn"], h, c, idx, cfg,
                                          self.geom, window, axis)
        if cfg.parallel_block:
            return x + out + apply_mlp(p["mlp"], h, cfg.mlp, axis)
        x = x + out
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        if kind == "moe":
            return x + self._moe(p["moe"], h2, moe_reps)[0]
        return x + apply_mlp(p["mlp"], h2, cfg.mlp, axis)


    # -- per-unit cost probes (the dry run's per-stage records) -----------
    def unit_param_defs(self, si: int) -> dict:
        """The param defs of one unit of stage ``si`` (unstacked)."""
        return {
            f"b{bi}": block_defs(kind, self.cfg, self.geom)
            for bi, kind in enumerate(self.stages[si].unit)
        }

    def unit_cache_defs(self, si: int, batch: int, max_len: int) -> dict:
        """The contiguous cache defs of one unit of stage ``si``."""
        return {f"b{bi}": self._block_cache_defs(kind, batch, max_len)
                for bi, kind in enumerate(self.stages[si].unit)}

    def unit_probe(self, si: int, kind: str):
        """A standalone function that runs one unit of stage ``si`` as the
        step runs it -- ``train``: forward and backward under the model's
        remat (the grads of the unit's params and input, from the JAX
        package's stand-in loss); ``prefill``: forward and cache collect;
        ``decode``: a one-token step with a cache update -- on this rank's
        parts (its model-axis shard, FSDP gathers included)."""
        st = self.stages[si]
        unit_fsdp = self.fsdp.layer(f"stage{si}") if self.fsdp else None

        def fwd(unit_params, x, positions, collect):
            unit = self._unit
            if self.remat != "none" and kind == "train":
                unit = _remat(unit, self.remat)
            # aux starts as a number: the step makes its zero once, not
            # a unit
            return unit(st, unit_params, x, 0.0, positions, collect,
                        x.shape[1], None, None, 0, unit_fsdp)

        if kind == "train":
            def probe(unit_params, x, positions):
                up = tree_map(lambda p: p.detach().requires_grad_(),
                              unit_params)
                xx = x.detach().requires_grad_()
                x2, aux, _ = fwd(up, xx, positions, False)
                loss = (x2.float() ** 2).sum() * 1e-6 + aux
                leaves = tree_leaves(up)
                grads = torch.autograd.grad(loss, [*leaves, xx],
                                            allow_unused=True,
                                            materialize_grads=True)
                by_leaf = {id(t): g for t, g in zip(leaves, grads)}
                return tree_map(lambda t: by_leaf[id(t)], up), grads[-1]
            return probe
        if kind == "prefill":
            def probe(unit_params, x, positions):
                return fwd(unit_params, x, positions, True)
            return probe
        if kind == "decode":
            def probe(unit_params, unit_cache, x, idx):
                idx = attn_mod.row_positions(idx, x.shape[0], x.device)
                x = self._decode_unit(st, unit_params, unit_cache, x, idx,
                                      None, unit_fsdp)
                return x, unit_cache
            return probe
        raise ValueError(f"unknown probe kind {kind!r}")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    matrix products without batch dimensions (``mm``, ``addmm``, and a
    ``bmm`` over a batch of one, which is how ``einsum`` runs a plain
    product), recompute everything else."""
    policy = torch_checkpoint.CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return policy.MUST_SAVE
    return policy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` recomputed in the backward pass: ``full`` keeps only its
    inputs, ``dots`` also the outputs ``_save_dots`` picks."""
    kw = {}
    if mode == "dots":
        kw["context_fn"] = partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_dots)
    return partial(torch_checkpoint.checkpoint, fn, use_reentrant=False,
                   **kw)


def _write_state(cache: dict, new: dict) -> None:
    """Copy a recurrent block's new conv tail and state into its cache
    views, IN PLACE, cast to the cache's dtype (where the JAX package's
    decode writes ``new.astype(buf.dtype)`` into the scan carry)."""
    for name, t in new.items():
        cache[name].copy_(t)

