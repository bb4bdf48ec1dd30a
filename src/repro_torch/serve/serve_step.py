"""Serving steps: batched prefill, single-token decode, and the
slot-granular variants that power the orchestrator's continuous batching.

``decode``       : (params, cache, tokens (B,1), idx)  -> (logits, cache)
``prefill_slot`` : (params, tokens (B,P), length)      -> (first_tokens (B,), cache)
``decode_slots`` : (params, cache, tokens (B,1), pos (B,))
                                                -> (next_tokens (B,), cache)

The slot variants treat the batch dimension as a bank of independent
*KV-cache slots*: each row is one in-flight request at its own depth.
The ``*_paged`` variants replace the per-slot slabs with a global page
pool + per-slot page table (kernels/paged_attention).

Same signatures and semantics as ``repro.serve.serve_step``, with two
PyTorch differences: a decode step updates the cache IN PLACE and returns
the same tensors, and the multi-step decode is a Python loop where the JAX
package scans.

Sampling masks physically-padded vocab columns so padded ids are never
emitted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

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


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Argmax over the real vocab (padded columns masked); ties go to the
    first index, as ``jnp.argmax``."""
    vp = logits.shape[-1]
    if vp != vocab_size:
        col = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(col, float("-inf"))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _rows_at(logits: torch.Tensor, pos) -> torch.Tensor:
    """logits (B,S,V) at per-row (or one shared) position(s) -> (B,V)."""
    B = logits.shape[0]
    pos = torch.as_tensor(pos, device=logits.device).reshape(-1).long()
    return logits[torch.arange(B, device=logits.device), pos.expand(B)]


@dataclass
class ServeStepBuilder:
    model: Model

    def build_decode(self) -> Callable:
        def decode(params, cache, tokens, idx):
            logits, cache = self.model.decode_step(params, cache, tokens, idx)
            return logits[:, -1], cache

        return decode

    def build_prefill_slot(self, cache_len: int,
                           frontend_len: int = 0) -> Callable:
        """Prefill request rows whose prompts are right-padded to a bucket.

        tokens: (B, P_bucket); length: count of real tokens -- an int for
        the orchestrator's one-request-per-prefill path (B=1) or a (B,)
        tensor. Returns (first_token (B,), cache padded to ``cache_len``).

        Right padding is causally safe for full attention: pad-position K/V
        land at positions >= the real content, which the causal mask hides
        until the decode loop overwrites them in place."""
        if frontend_len:
            raise NotImplementedError(
                "frontend embeddings are not ported yet (ROADMAP.md Queue 1 "
                "item 10: other model families)")
        vocab = self.model.cfg.vocab_size

        def prefill_slot(params, tokens, length):
            logits, cache, _ = self.model.forward(
                params, tokens, collect_cache=True, cache_len=cache_len)
            last = _rows_at(logits, torch.as_tensor(length) - 1)
            return greedy_sample(last, vocab), cache

        return prefill_slot

    def build_decode_slots(self) -> Callable:
        """One decode tick over a slot bank: every row advances by one token
        at its own position. Free slots decode garbage into their own rows,
        which the next insertion overwrites."""
        decode = self.build_decode()
        vocab = self.model.cfg.vocab_size

        def decode_slots(params, cache, tokens, pos):
            logits, cache = decode(params, cache, tokens, pos)
            return greedy_sample(logits, vocab), cache

        return decode_slots

    def build_decode_chunk(self, n_steps: int) -> Callable:
        """Multi-step slot decode: ``n_steps`` ticks in one dispatch (a
        Python loop). Slots that finish mid-chunk keep decoding until the
        chunk boundary; the host discards their surplus tokens.

        (params, cache, tokens (B,1), pos (B,)) ->
            (toks (B, n_steps), next_tokens (B,1), pos+n_steps, cache)
        """
        decode = self.build_decode()
        vocab = self.model.cfg.vocab_size

        def decode_chunk(params, cache, tokens, pos):
            toks = []
            tok = tokens
            for _ in range(n_steps):
                logits, cache = decode(params, cache, tok, pos)
                tok = greedy_sample(logits, vocab)[:, None]
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
        page_size, hd) with n_prompt_pages = ceil(prompt_len / page_size).
        The host writes row j into physical page ``table[slot, j]``.

        With ``prefix_len`` > 0 (prefix-registry hit) this is the SUFFIX
        prefill: ``tokens`` are only the uncached tail (bucketed to
        ``prompt_len``), the signature gains the live page pool and the
        (ceil(prefix_len / page_size),) physical page ids of the matched
        prefix, and query positions are offset past the prefix. When
        ``prefix_len`` ends mid-page, the boundary page's first
        ``prefix_len % page_size`` positions are copied ahead of the suffix
        KV (the front-partial merge), so the returned cache starts
        page-aligned; the pool itself is only read."""
        if frontend_len:
            raise NotImplementedError(
                "frontend embeddings are not ported yet (ROADMAP.md Queue 1 "
                "item 10: other model families)")
        if prefix_len:
            span = prompt_len                  # the suffix bucket
            vocab = self.model.cfg.vocab_size
            frac = prefix_len % page_size      # front-partial merge width
            np_ = -(-(frac + span) // page_size)
            pad = np_ * page_size - (frac + span)

            def prefill_suffix_paged(params, pool, tokens, length,
                                     prefix_pages):
                logits, cache, _ = self.model.forward(
                    params, tokens, collect_cache=True, cache_len=span,
                    prefix_kv=pool, prefix_pages=prefix_pages,
                    prefix_len=prefix_len)
                first = greedy_sample(
                    _rows_at(logits, torch.as_tensor(length) - 1), vocab)

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

        span = prompt_len
        inner = self.build_prefill_slot(span)
        np_ = -(-span // page_size)
        pad = np_ * page_size - span

        def prefill_slot_paged(params, tokens, length):
            first, cache = inner(params, tokens, length)

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
        vocab = self.model.cfg.vocab_size

        def decode_slots_paged(params, cache, tokens, pos, page_table):
            logits, cache = self.model.decode_step(
                params, cache, tokens, pos, page_table=page_table)
            return greedy_sample(logits[:, -1], vocab), cache

        return decode_slots_paged

    def build_decode_chunk_paged(self, n_steps: int) -> Callable:
        """Multi-step paged slot decode. The page table is FIXED for the
        whole chunk: the scheduler pre-allocates pages covering every write
        position pos..pos+n_steps-1 before dispatch."""
        vocab = self.model.cfg.vocab_size

        def decode_chunk_paged(params, cache, tokens, pos, page_table):
            toks = []
            tok = tokens
            for _ in range(n_steps):
                logits, cache = self.model.decode_step(
                    params, cache, tok, pos, page_table=page_table)
                tok = greedy_sample(logits[:, -1], vocab)[:, None]
                toks.append(tok[:, 0])
                pos = pos + 1
            return torch.stack(toks, dim=1), tok, pos, cache

        return decode_chunk_paged
