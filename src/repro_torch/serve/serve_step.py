"""Serving steps: batched prefill, single-token decode, and the
slot-granular variants that power the orchestrator's continuous batching.

``prefill``      : (params, tokens[, frontend_embeds]) -> (last_logits, cache)
``decode``       : (params, cache, tokens (B,1), idx)  -> (logits, cache)
``prefill_slot`` : (params, tokens (B,P), length[, frontend_embeds, fe_len])
                                                -> (first_tokens (B,), cache)
``decode_slots`` : (params, cache, tokens (B,1), pos (B,))
                                                -> (next_tokens (B,), cache)
``generate``     : (params, cache, first (B,1), start) -> (toks (B,G), cache)

``prefill`` and ``decode`` are the whole-batch (lockstep) path: every row
is one prompt of the same length, and ``idx`` may be one scalar position
for the whole batch.

Frontend-embedding archs (musicgen / internvl2) prepend a per-request
modality prefix: ``prefill_slot`` built with ``frontend_len=F`` takes an
(B, F, d_model) embedding buffer plus the per-row count of real prefix rows
and packs [prefix, prompt] contiguously, so the KV cache covers
prefix+prompt and decode proceeds at absolute positions fe_len+len+t with
no further frontend involvement.

The slot variants treat the batch dimension as a bank of independent
*KV-cache slots*: each row is one in-flight request at its own depth.
The ``*_paged`` variants replace the per-slot slabs with a global page
pool + per-slot page table (kernels/paged_attention).

Same signatures and semantics as ``repro.serve.serve_step``, with two
PyTorch differences: a decode step updates the cache IN PLACE and returns
the same tensors, and the multi-step decodes are Python loops where the
JAX package scans.

Sampling masks physically-padded vocab columns so padded ids are never
emitted.

On a model axis (the model's ``ModelAxis``) a rank holds its shards of
the params and its part of the cache, the logits a step returns are its
vocab slice (the reference's ``("batch", "vocab")`` out-sharding), and
the greedy sample is an exact argmax over the slices (``greedy_sample``):
every rank gets the same token, the one a single process picks.

A builder given ``replicas`` builds steps whose rows are this rank's
block of a batch split over the mesh's batch axes (a slot bank's rows):
the model's MoE dispatch then runs over the global batch where the
reference's does (``Model.moe_replicas``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.dist.sharding import ModelAxis, Replicas, gather_from_model
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import Model


# dispatch classes for compile accounting (Container.compile_serve_step
# buckets cache hits/misses per class; SlotEngine.status surfaces them)
PREFILL_STEPS = frozenset({"prefill", "prefill_slot", "prefill_slot_paged"})
DECODE_STEPS = frozenset({"decode", "decode_slots", "decode_chunk",
                          "decode_slots_paged", "decode_chunk_paged"})


def dispatch_class(kind: str) -> str:
    """\"prefill\" | \"decode\" | \"other\" for a serve-step kind."""
    if kind in PREFILL_STEPS:
        return "prefill"
    if kind in DECODE_STEPS:
        return "decode"
    return "other"


def greedy_sample(logits: torch.Tensor, vocab_size: int,
                  axis: ModelAxis | None = None) -> torch.Tensor:
    """Argmax over the real vocab (padded columns masked); ties go to the
    first index, as ``jnp.argmax``.

    On a model axis ``logits`` is the rank's vocab slice: each rank masks
    its columns past ``vocab_size``, takes its slice's maximum and first
    index, and the (max, global index) pairs are gathered over the axis
    -- B pairs a rank, not B x Vp logits. The largest value wins, a tie
    going to the lowest global index (the first rank that holds it), so
    every rank returns the token one process would."""
    vp = logits.shape[-1]
    lo = axis.coord * vp if axis is not None else 0
    if lo + vp > vocab_size:
        col = lo + torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(col, float("-inf"))
    best = torch.argmax(logits, dim=-1)
    if axis is None:
        return best.to(torch.int32)
    # value and index in float64: exact for any logit dtype and any id
    pair = torch.stack([torch.gather(logits, -1, best[..., None])[..., 0]
                        .double(), (best + lo).double()])
    pairs = gather_from_model(pair[None], axis)      # (tp, 2, ...)
    win = torch.argmax(pairs[:, 0], dim=0)           # first rank at the max
    return torch.gather(pairs[:, 1], 0, win[None])[0].to(torch.int32)


def _rows_at(logits: torch.Tensor, pos) -> torch.Tensor:
    """logits (B,S,V) at per-row (or one shared) position(s) -> (B,V)."""
    B = logits.shape[0]
    pos = torch.as_tensor(pos, device=logits.device).reshape(-1).long()
    return logits[torch.arange(B, device=logits.device), pos.expand(B)]


@dataclass
class ServeStepBuilder:
    model: Model
    replicas: Replicas | None = None

    def build_prefill(self, cache_len: int) -> Callable:
        """Whole-batch prefill of (B, S) prompts (after a (B, F, D)
        ``frontend_embeds`` prefix, where the arch has one) into a cache
        of ``cache_len`` positions -> (last logits (B, Vp), cache). The
        last row is copied out, so the full (B, S, Vp) logits are freed
        when the step returns. On a model axis the logits are the rank's
        (B, Vp/tp) vocab slice and the cache its part."""
        def prefill(params, tokens, frontend_embeds=None):
            logits, cache, _ = self.model.forward(
                params, tokens, frontend_embeds=frontend_embeds,
                collect_cache=True, cache_len=cache_len,
                replicas=self.replicas)
            return logits[:, -1].clone(), cache

        return prefill

    def build_decode(self) -> Callable:
        """One decode step at ``idx``: a scalar (lockstep batch) or (B,)
        per-row positions -> (logits (B, Vp), cache); on a model axis the
        rank's (B, Vp/tp) vocab slice."""
        def decode(params, cache, tokens, idx):
            logits, cache = self.model.decode_step(params, cache, tokens, idx,
                                                   replicas=self.replicas)
            return logits[:, -1], cache

        return decode

    def build_prefill_slot(self, cache_len: int,
                           frontend_len: int = 0) -> Callable:
        """Prefill request rows whose prompts are right-padded to a bucket.

        tokens: (B, P_bucket); length: count of real tokens -- an int for
        the orchestrator's one-request-per-prefill path (B=1) or a (B,)
        tensor. Returns (first_token (B,), cache padded to ``cache_len``).

        With ``frontend_len`` > 0 the signature gains
        ``(frontend_embeds (B, F, D), fe_len)``: a modality prefix consumed
        AHEAD of the token prompt (packed contiguously by Model.forward, so
        tokens sit at positions fe_len..fe_len+length-1 and the first token
        is sampled at position fe_len+length-1); ``fe_len`` is an int or a
        (B,) tensor.

        Right padding is causally safe for full attention: pad-position K/V
        land at positions >= the real content, which the causal mask hides
        until the decode loop overwrites them in place."""
        vocab, axis = self.model.cfg.vocab_size, self.model.axis

        if frontend_len:
            def prefill_slot_fe(params, tokens, length, frontend_embeds,
                                fe_len):
                logits, cache, _ = self.model.forward(
                    params, tokens, frontend_embeds=frontend_embeds,
                    frontend_len=fe_len, collect_cache=True,
                    cache_len=cache_len, replicas=self.replicas)
                last_pos = (torch.as_tensor(fe_len, device=logits.device)
                            + torch.as_tensor(length, device=logits.device)
                            - 1)
                first = greedy_sample(_rows_at(logits, last_pos), vocab,
                                      axis)
                return first, cache

            return prefill_slot_fe

        def prefill_slot(params, tokens, length):
            logits, cache, _ = self.model.forward(
                params, tokens, collect_cache=True, cache_len=cache_len,
                replicas=self.replicas)
            last = _rows_at(logits, torch.as_tensor(length) - 1)
            return greedy_sample(last, vocab, axis), cache

        return prefill_slot

    def build_decode_slots(self) -> Callable:
        """One decode tick over a slot bank: every row advances by one token
        at its own position. Free slots decode garbage into their own rows,
        which the next insertion overwrites."""
        decode = self.build_decode()
        vocab, axis = self.model.cfg.vocab_size, self.model.axis

        def decode_slots(params, cache, tokens, pos):
            logits, cache = decode(params, cache, tokens, pos)
            return greedy_sample(logits, vocab, axis), cache

        return decode_slots

    def build_decode_chunk(self, n_steps: int) -> Callable:
        """Multi-step slot decode: ``n_steps`` ticks in one dispatch (a
        Python loop). Slots that finish mid-chunk keep decoding until the
        chunk boundary; the host discards their surplus tokens.

        (params, cache, tokens (B,1), pos (B,)) ->
            (toks (B, n_steps), next_tokens (B,1), pos+n_steps, cache)
        """
        decode = self.build_decode()
        vocab, axis = self.model.cfg.vocab_size, self.model.axis

        def decode_chunk(params, cache, tokens, pos):
            toks = []
            tok = tokens
            for _ in range(n_steps):
                logits, cache = decode(params, cache, tok, pos)
                tok = greedy_sample(logits, vocab, axis)[:, None]
                toks.append(tok[:, 0])
                pos = pos + 1
            return torch.stack(toks, dim=1), tok, pos, cache

        return decode_chunk

    # -- paged variants (KV in a global page pool; see kernels/paged_attention
    # and orchestrator/page_pool.py) ----------------------------------------

    def build_prefill_slot_paged(self, prompt_len: int, page_size: int,
                                 frontend_len: int = 0,
                                 prefix_len: int = 0) -> Callable:
        """prefill_slot whose cache comes back PAGE-MAJOR, ready to scatter
        into the pool: each attention entry is (count, n_kv, n_prompt_pages,
        page_size, hd) with n_prompt_pages = ceil((frontend_len +
        prompt_len) / page_size): a frontend arch's prefix occupies the
        leading cache positions, as in the contiguous layout, and the
        signature gains ``(frontend_embeds, fe_len)``. The host writes row
        j into physical page ``table[slot, j]``.

        With ``prefix_len`` > 0 (prefix-registry hit) this is the SUFFIX
        prefill: ``tokens`` are only the uncached tail (bucketed to
        ``prompt_len``), the signature gains the live page pool and the
        (ceil(prefix_len / page_size),) physical page ids of the matched
        prefix, and query positions are offset past the prefix. When
        ``prefix_len`` ends mid-page, the boundary page's first
        ``prefix_len % page_size`` positions are copied ahead of the suffix
        KV (the front-partial merge), so the returned cache starts
        page-aligned; the pool itself is only read."""
        if prefix_len:
            if frontend_len:
                raise NotImplementedError(
                    "prefix-cached suffix prefill does not compose with "
                    "frontend embeddings")
            span = prompt_len                  # the suffix bucket
            vocab, axis = self.model.cfg.vocab_size, self.model.axis
            frac = prefix_len % page_size      # front-partial merge width
            np_ = -(-(frac + span) // page_size)
            pad = np_ * page_size - (frac + span)

            def prefill_suffix_paged(params, pool, tokens, length,
                                     prefix_pages):
                logits, cache, _ = self.model.forward(
                    params, tokens, collect_cache=True, cache_len=span,
                    prefix_kv=pool, prefix_pages=prefix_pages,
                    prefix_len=prefix_len, replicas=self.replicas)
                first = greedy_sample(
                    _rows_at(logits, torch.as_tensor(length) - 1), vocab,
                    axis)

                def to_pages(e, pl):
                    # e: (count, 1, S, n_kv, hd) suffix cache;
                    # pl: (count, n_kv, n_pages, ps, hd) live pool leaf
                    e = e[:, 0]
                    if frac:
                        # front-partial merge: the shared boundary page's
                        # first ``frac`` positions lead the slot's first
                        # private page
                        bp = torch.index_select(
                            pl, 2, prefix_pages[-1:].long())[:, :, 0]
                        bp = bp[:, :, :frac].permute(0, 2, 1, 3)
                        e = torch.cat([bp.to(e.dtype), e], dim=1)
                    if pad:
                        e = torch.nn.functional.pad(e, (0, 0, 0, 0, 0, pad))
                    cnt, _, n_kv, hd = e.shape
                    e = e.reshape(cnt, np_, page_size, n_kv, hd)
                    return e.permute(0, 3, 1, 2, 4)

                return first, tree_map(to_pages, cache, pool)

            return prefill_suffix_paged

        span = prompt_len + frontend_len
        inner = self.build_prefill_slot(span, frontend_len)
        np_ = -(-span // page_size)
        pad = np_ * page_size - span

        def prefill_slot_paged(params, tokens, length, *fe_args):
            first, cache = inner(params, tokens, length, *fe_args)

            def to_pages(e):
                # (count, 1, S, n_kv, hd) -> (count, n_kv, np_, ps, hd)
                e = e[:, 0]
                if pad:
                    e = torch.nn.functional.pad(e, (0, 0, 0, 0, 0, pad))
                cnt, _, n_kv, hd = e.shape
                e = e.reshape(cnt, np_, page_size, n_kv, hd)
                return e.permute(0, 3, 1, 2, 4)

            return first, tree_map(to_pages, cache)

        return prefill_slot_paged

    def build_decode_slots_paged(self) -> Callable:
        """One decode tick over the slot bank with paged KV: identical
        semantics to decode_slots plus the (B, max_pages) page table."""
        vocab, axis = self.model.cfg.vocab_size, self.model.axis

        def decode_slots_paged(params, cache, tokens, pos, page_table):
            logits, cache = self.model.decode_step(
                params, cache, tokens, pos, page_table=page_table,
                replicas=self.replicas)
            return greedy_sample(logits[:, -1], vocab, axis), cache

        return decode_slots_paged

    def build_decode_chunk_paged(self, n_steps: int) -> Callable:
        """Multi-step paged slot decode. The page table is FIXED for the
        whole chunk: the scheduler pre-allocates pages covering every write
        position pos..pos+n_steps-1 before dispatch."""
        vocab, axis = self.model.cfg.vocab_size, self.model.axis

        def decode_chunk_paged(params, cache, tokens, pos, page_table):
            toks = []
            tok = tokens
            for _ in range(n_steps):
                logits, cache = self.model.decode_step(
                    params, cache, tok, pos, page_table=page_table,
                    replicas=self.replicas)
                tok = greedy_sample(logits[:, -1], vocab, axis)[:, None]
                toks.append(tok[:, 0])
                pos = pos + 1
            return torch.stack(toks, dim=1), tok, pos, cache

        return decode_chunk_paged

    def build_generate_loop(self, n_steps: int,
                            per_row: bool = False) -> Callable:
        """Greedy autoregressive loop of ``n_steps`` decode steps (the
        static serving driver's decode): ``build_decode_chunk``'s loop from
        ``start_idx``, one scalar position for every row, or with
        ``per_row`` a (B,) tensor of per-row start positions (a wave of
        mixed-length prompts). A start of the other rank raises.

        (params, cache, first_token (B,1), start_idx) ->
            (toks (B, n_steps), cache)
        """
        chunk = self.build_decode_chunk(n_steps)

        def generate(params, cache, first_token, start_idx):
            idx = torch.as_tensor(start_idx, dtype=torch.int32,
                                  device=first_token.device)
            want = (first_token.shape[0],) if per_row else ()
            if tuple(idx.shape) != want:
                raise ValueError(
                    f"generate: start_idx of shape {tuple(idx.shape)}, "
                    f"expected {want} (per_row={per_row})")
            toks, _, _, cache = chunk(params, cache, first_token, idx)
            return toks, cache

        return generate
