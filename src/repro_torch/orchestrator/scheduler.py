"""Continuous batching: slot engines + the interleaved prefill/decode loop.

``SlotEngine`` owns one Container replica's serving state: a bank of
``n_slots`` KV-cache slots (one in-flight request per slot, free slots on a
free-list), compiled prefill/decode executables (via the Container's
CompileCache -- replicas after the first warm-start), and per-slot host
bookkeeping (position, last token, owning request).

``ContinuousScheduler`` drives a Pod of engines: each global *tick* first
admits queued requests FIFO into free slots (bounded by ``fairness_cap``
prefills per tick so admission never starves decode), then runs ONE decode
step per engine in which every active slot advances by one token at its own
depth. Requests exit early on EOS or their token budget; their slot returns
to the free-list the same tick and can be refilled on the next -- the
Orca-style iteration-level scheduling loop.

PyTorch port of ``repro.orchestrator.scheduler``: the same admission,
prefix-registry and decode logic, line for line. Where the JAX package
runs jitted, donating helpers that return a new cache, the port writes
the slot bank or page pool IN PLACE with index assignment (``_insert_slot``,
``_insert_pages``), and the spill save path copies pages OUT (``.cpu()``)
because the pool is mutable.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.orchestrator.obs.metrics import MetricsRegistry
from repro_torch.orchestrator.obs.report import (ITL_HIST, TICK_HIST,
                                           observe_completion)
from repro_torch.orchestrator.obs.tracing import TraceBuffer
from repro_torch.orchestrator.page_pool import PagePool
from repro_torch.orchestrator.prefix_registry import PrefixMatch
from repro_torch.orchestrator.request_queue import GenRequest, RequestQueue
from repro_torch.models.params import tree_map

_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _insert_slot(big, small, slot: int):
    """Write one request's (batch=1) cache into row ``slot`` of the bank,
    IN PLACE (leaves: (count, n_slots, ...) <- (count, 1, ...))."""
    def leaf(b, s):
        b[:, slot:slot + 1] = s.to(b.dtype)
        return b
    return tree_map(leaf, big, small)


def _insert_pages(big, small, row: torch.Tensor):
    """Scatter one request's page-major prefill cache into the pool, IN
    PLACE.

    ``small`` leaves: (count, n_kv, n_prompt_pages, ps, hd);
    ``row``: (n_prompt_pages,) physical page ids for the slot. Entries past
    the allocated prefix are the garbage page 0 -- the prompt's right-pad
    pages land there (several at once, in no defined order: harmless,
    because page 0 is never read unmasked)."""
    def leaf(b, s):
        b[:, :, row] = s.to(b.dtype)
        return b
    return tree_map(leaf, big, small)


def _gather_pages(big, rows: torch.Tensor):
    """COPY the pool pages at ``rows`` out of the live cache to host memory
    (the spill save path). The pool is updated in place by later
    dispatches, so the payload must not alias it."""
    def leaf(b):
        return torch.index_select(b, 2, rows).cpu()
    return tree_map(leaf, big)


class SlotEngine:
    def __init__(self, container, params, *, n_slots: int, max_len: int,
                 eos_id: int | None = None, name: str | None = None,
                 decode_chunk: int = 4, paged: bool = False,
                 page_size: int = 16, n_pages: int | None = None,
                 prefix_cache: bool = False,
                 spill_pages: int | None = 0,
                 metrics: MetricsRegistry | None = None,
                 trace: TraceBuffer | None = None):
        self.container = container
        self.params = params
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.name = name or container.container_id
        self.chunk = max(1, int(decode_chunk))
        self.paged = bool(paged)
        # copy-on-write prefix page cache: requests declaring a shared
        # leading token block (GenRequest.prefix_len) reuse each other's
        # prefix KV pages instead of re-prefilling them
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires paged=True "
                             "(prefix sharing is page-granular)")

        # ring-buffer (windowed) and recurrent caches are not right-pad safe
        # (see ServeStepBuilder.build_prefill_slot): use exact-length prefill
        kinds = {k for st in container.model.stages for k in st.unit}
        cfg = container.arch
        # frontend-embedding archs (musicgen/internvl2): every prefill
        # executable carries a static (1, fe_len, d_model) prefix buffer;
        # requests supply up to fe_len real rows (packed ahead of the prompt)
        self.fe_len = cfg.frontend_len if cfg.frontend else 0
        self.d_model = cfg.d_model
        self.fe_dtype = container.cache_dtype
        if cfg.frontend:
            raise NotImplementedError(
                "frontend-embedding serving is not ported yet (ROADMAP.md "
                "Queue 1 item 10: other model families)")
        self.device = container.device
        self.exact_prefill = bool(
            kinds & {"ssm", "rec", "local"}
            or (cfg.window and cfg.attn_kind == "local"))

        # observability: the owning Pod shares its registry + span buffer
        # across replicas; a standalone engine (unit test, single-replica
        # benchmark) gets private ones
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = trace if trace is not None else TraceBuffer(name=self.name)

        if self.paged:
            if self.exact_prefill:
                raise NotImplementedError(
                    "paged KV serving supports full-attention archs only "
                    "(windowed/recurrent caches stay contiguous)")
            self.page_size = int(page_size)
            # max_len becomes the page-TABLE span (per-request position
            # ceiling), decoupled from per-slot memory: pages are the budget
            self.max_pages = -(-self.max_len // self.page_size)
            # default pool = the HBM a contiguous bank of the same
            # (n_slots, max_len) geometry would pin, + the garbage page
            self.n_pages = int(n_pages) if n_pages else (
                self.n_slots * self.max_pages + 1)
            self.pool = PagePool(self.n_pages, self.page_size,
                                 self.n_slots, self.max_pages,
                                 metrics=self.metrics, replica=self.name,
                                 spill_pages=spill_pages)
            shapes = dict(batch=self.n_slots, n_pages=self.n_pages,
                          page_size=self.page_size, max_pages=self.max_pages)
            one_kind, chunk_kind = "decode_slots_paged", "decode_chunk_paged"
        else:
            self.pool = None
            shapes = dict(batch=self.n_slots, cache_len=self.max_len)
            one_kind, chunk_kind = "decode_slots", "decode_chunk"
        if self.chunk == 1:
            # single-tick primitive: same semantics, no scan wrapper
            # (*extra = the page table in paged mode, nothing otherwise)
            one = container.compile_serve_step(one_kind, **shapes)

            def decode(params, cache, toks, pos, *extra):
                nxt, cache = one(params, cache, toks, pos, *extra)
                return nxt[:, None], nxt[:, None], pos + 1, cache

            self.decode = decode
        else:
            self.decode = container.compile_serve_step(
                chunk_kind, gen_steps=self.chunk, **shapes)
        self._prefills: dict[int, object] = {}      # bucket len -> executable
        self._insert = _insert_slot

        self.cache = (container.init_paged_cache(self.n_pages, self.page_size)
                      if self.paged
                      else container.init_slot_cache(self.n_slots, self.max_len))
        if self.paged:
            # device side of the registry's spill tier: the pool calls
            # these to move page contents pool <-> host RAM. Both run
            # BEFORE any dispatch that writes the pool (the engine
            # sequences pool bookkeeping ahead of prefill/decode).
            self.pool.set_spill_io(self._spill_save, self._spill_load)
        self.pos = np.zeros(self.n_slots, np.int32)
        self.cur_tok = np.zeros(self.n_slots, np.int32)
        self.free: list[int] = list(range(self.n_slots))
        self.active: dict[int, GenRequest] = {}
        self.draining = False
        self.stopped = False

        # accounting (for ps/status + the fig6/fig9 benchmarks): tick-clocked
        # counts live in the shared registry, labelled per replica; the old
        # attribute names survive below as read-only property shims. Wall
        # timings (prefill_s/decode_s) stay plain attributes ON PURPOSE --
        # the registry must snapshot bitwise-identically for identical
        # request traces, so wall-clock state never enters it.
        lab = dict(replica=self.name)
        self._c_slots_alloc = self.metrics.counter("slots_allocated", **lab)
        self._c_slots_freed = self.metrics.counter("slots_freed", **lab)
        self._c_decode_ticks = self.metrics.counter("decode_ticks", **lab)
        self._c_tokens = self.metrics.counter("tokens_generated", **lab)
        self._c_positions = self.metrics.counter("prefill_positions", **lab)
        self._c_phits = self.metrics.counter("prefix_hits", **lab)
        self._c_pmiss = self.metrics.counter("prefix_misses", **lab)
        self._c_psaved = self.metrics.counter("prefix_tokens_saved", **lab)
        # radix-registry hit taxonomy: ANCESTOR hits matched fewer complete
        # blocks than the request declared (sharing a shorter family
        # prefix), PARTIAL hits matched only a mid-block boundary (the
        # front-partial merge with no whole shared row)
        self._c_pancestor = self.metrics.counter("prefix_ancestor_hits",
                                                 **lab)
        self._c_ppartial = self.metrics.counter("prefix_partial_hits", **lab)
        # decode-chunk overshoot discards (bounded, counted waste): the
        # visible cost signal for decode_chunk tuning
        self._c_wasted = self.metrics.counter("tokens_wasted", **lab)
        self._c_prefill_disp = self.metrics.counter("prefill_dispatches",
                                                    **lab)
        self._c_decode_disp = self.metrics.counter("decode_dispatches", **lab)
        # page-level preemption: pauses (pages released mid-decode) and
        # resumes (suffix re-prefill of prompt + generated-so-far)
        self._c_preempted = self.metrics.counter("preemptions", **lab)
        self._c_resumed = self.metrics.counter("resumes", **lab)
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # registry-backed shims for the pre-registry attribute names
    @property
    def slots_allocated(self) -> int:
        return self._c_slots_alloc.value

    @property
    def slots_freed(self) -> int:
        return self._c_slots_freed.value

    @property
    def decode_ticks(self) -> int:
        return self._c_decode_ticks.value

    @property
    def tokens_generated(self) -> int:
        return self._c_tokens.value

    @property
    def prefill_positions(self) -> int:
        return self._c_positions.value

    @property
    def prefix_hits(self) -> int:
        return self._c_phits.value

    @property
    def prefix_misses(self) -> int:
        return self._c_pmiss.value

    @property
    def prefix_tokens_saved(self) -> int:
        return self._c_psaved.value

    @property
    def prefix_ancestor_hits(self) -> int:
        return self._c_pancestor.value

    @property
    def prefix_partial_hits(self) -> int:
        return self._c_ppartial.value

    @property
    def tokens_wasted(self) -> int:
        return self._c_wasted.value

    @property
    def preemptions(self) -> int:
        return self._c_preempted.value

    @property
    def resumes(self) -> int:
        return self._c_resumed.value

    # -- admission ----------------------------------------------------------
    def has_free(self) -> bool:
        return bool(self.free) and not (self.draining or self.stopped)

    def supports(self, req: GenRequest) -> bool:
        """Arch compatibility: a frontend prefix needs a frontend arch with
        a wide-enough prefix buffer and a matching embedding width."""
        if req.frontend is None:
            return True
        return (req.frontend_len <= self.fe_len
                and req.frontend.shape[1] == self.d_model)

    def span(self, req: GenRequest) -> int:
        """KV positions the request occupies on THIS engine: the STATIC
        frontend-buffer width (not the request's own prefix length) because
        the prefill executable's cache covers fe_len + bucket rows no
        matter how many prefix rows are real."""
        return self.fe_len + req.prompt_len + req.max_new_tokens

    def pages_needed(self, req: GenRequest) -> int:
        """Worst-case page footprint: chunked decode can write up to
        ``chunk`` positions past the final token (overshoot discard)."""
        return self.pool.pages_for(self.span(req) + self.chunk)

    def fits(self, req: GenRequest) -> bool:
        """Permanent feasibility: could this request EVER run here?

        ``max_len`` is the authoritative per-request span in BOTH modes
        (the page table rounds it up to whole pages, but prefill buckets
        clamp at max_len, so admitting into the rounding slack would
        crash prefill); paged mode additionally needs the footprint to
        fit the pool."""
        if not self.supports(req):
            return False
        if self.span(req) + self.chunk > self.max_len:
            return False
        return (not self.paged
                or self.pages_needed(req) <= self.pool.capacity)

    # -- prefix registry -----------------------------------------------------
    def _prefix_tokens(self, req: GenRequest):
        """The declared-prefix tokens this request could SHARE through the
        radix registry, or None. Capped at prompt_len - 1 so the suffix
        prefill always keeps >= 1 real token to sample the first output
        from. Frontend requests/archs bypass the registry: their leading KV
        rows are per-request embeddings, not shareable prompt pages."""
        if not (self.prefix_cache and self.paged) or self.fe_len:
            return None
        if req.frontend is not None or not req.prefix_len:
            return None
        cap = min(req.prefix_len, req.prompt_len - 1)
        if cap < 1:
            return None
        return req.prompt[:cap]

    def prefix_hit(self, req: GenRequest, touch: bool = False):
        """The request's longest registered ancestry as a ``PrefixMatch``
        (whole shared blocks root-first, plus an optional mid-block partial
        boundary), or None when nothing matches. The radix walk compares
        token blocks byte-for-byte, so a chained-digest collision over
        different tokens is a MISS at that depth, never a wrong share."""
        toks = self._prefix_tokens(req)
        if toks is None:
            return None
        m = self.pool.match(toks, touch=touch)
        if not m.all_nodes():
            return None
        return m

    def can_start(self, req: GenRequest) -> bool:
        """Right-now feasibility: a free slot AND (paged) enough unreserved
        pool pages to cover the request's worst case. False here is
        *backpressure*, not rejection -- the scheduler retries next tick.
        A registry hit shrinks the footprint to the suffix pages, plus the
        one-time cost of pinning currently-evictable chain nodes and of the
        free pages any spilled chain node needs to restore into."""
        if not (self.has_free() and self.fits(req)):
            return False
        if not self.paged:
            return True
        hit = self.prefix_hit(req)
        if hit is not None:
            return self.pool.can_reserve(
                self.pages_needed(req) - len(hit.nodes)
                + self.pool.pin_cost(hit) + self.pool.restore_cost(hit))
        return self.pool.can_reserve(self.pages_needed(req))

    def _spill_save(self, page: int):
        """Device -> host: copy one pool page out of the live cache (per
        layer/stage) into host memory. A copy, never a view: the pool keeps
        changing in place after the spill."""
        return _gather_pages(self.cache, self._ids([page]))

    def _spill_load(self, page: int, payload) -> None:
        """Host -> device: scatter a restored payload back into ``page``
        (the registry pull). Reuses the prefill scatter with a one-page
        row."""
        self.cache = _insert_pages(
            self.cache, tree_map(lambda t: t.to(self.device), payload),
            self._ids([page]))

    def _ids(self, values) -> torch.Tensor:
        """Host integers -> an int32 tensor on this engine's device."""
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    def _drain_tier_events(self, rid: int, tick: int) -> None:
        """Record the pool's spill/restore movements since the last drain
        as spans under the request whose allocation triggered them."""
        for kind, digest in self.pool.drain_events():
            if kind == "spill":
                self.trace.record(rid, "spill", tick, replica=self.name,
                                  digest=digest)
            else:
                self.trace.record(rid, "restore", tick, replica=self.name,
                                  digest=digest)

    def reject_reason(self, req: GenRequest) -> str:
        """Why ``fits`` is False -- the oversized-rejection error path."""
        if not self.supports(req):
            if not self.fe_len:
                return (f"frontend prefix ({req.frontend_len} rows) on "
                        f"text-only arch {self.container.arch.name}")
            if req.frontend_len > self.fe_len:
                return (f"frontend prefix {req.frontend_len} exceeds arch "
                        f"frontend_len {self.fe_len}")
            return (f"frontend embedding width {req.frontend.shape[1]} != "
                    f"d_model {self.d_model}")
        what = "frontend+prompt+gen" if self.fe_len else "prompt+gen"
        if self.paged:
            if self.span(req) + self.chunk > self.max_len:
                return (f"{what}+chunk {self.span(req) + self.chunk} "
                        f"exceeds page-table span {self.max_len} "
                        f"({self.max_pages} pages x {self.page_size})")
            return (f"{what}+chunk {self.span(req) + self.chunk} needs "
                    f"{self.pages_needed(req)} pages; pool capacity is "
                    f"{self.pool.capacity}")
        return (f"{what} {self.span(req)} exceeds slot capacity "
                f"{self.max_len - self.chunk}")

    def bucket(self, prompt_len: int) -> int:
        # the cache row budget left for tokens after the frontend buffer
        cap = self.max_len - self.fe_len
        if self.exact_prefill:
            return prompt_len
        for b in _PREFILL_BUCKETS:
            if b >= prompt_len:
                return min(b, cap)
        return prompt_len

    def start(self, req: GenRequest, tick: int) -> bool:
        """Prefill ``req`` into a free slot. Returns True if the request
        already finished at prefill (budget of one token, or instant EOS).

        A PREEMPTED request resumes here through the same path: its pages
        were released at preemption, so the prefill recomputes KV for the
        prompt plus every token generated before the pause except the last
        -- that one stays the decode cursor, exactly where the unpreempted
        run left it, so the continuation is token-for-token identical."""
        # chunked decode can overshoot a finished request by chunk-1 writes;
        # the scheduler pre-screens, so tripping this is an internal bug
        if not self.fits(req):
            raise ValueError(f"request {req.rid}: {self.reject_reason(req)}")
        resuming = req.state == "preempted"
        slot = self.free.pop(0)
        self._c_slots_alloc.inc()
        req.slot, req.replica, req.state = slot, self.name, "running"
        if req.admit_tick < 0:
            # FIRST admission only: a resume never moves the TTFT anchor
            req.admit_tick = tick
        if resuming:
            self._c_resumed.inc()
            self.trace.record(req.rid, "resume", tick, replica=self.name,
                              slot=slot, tokens_done=len(req.tokens))
            seq = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        else:
            self.trace.record(req.rid, "admit", tick, replica=self.name,
                              slot=slot, priority=req.priority)
            seq = req.prompt

        P = int(seq.shape[0])
        hit = self.prefix_hit(req) if self.paged else None
        if hit is not None:
            # HIT: map the matched radix chain's pages read-only into the
            # slot's leading table rows and prefill ONLY the unmatched
            # suffix, positions offset past the match (which may end
            # MID-page: the boundary node's page rides along as the
            # front-partial merge operand). ALL pool bookkeeping --
            # reservation, chain mapping, spill-tier restores, private
            # allocation -- runs BEFORE the dispatch because the suffix
            # prefill READS the live pool at the chain's pages.
            k = len(hit.nodes)                  # whole shared table rows
            L = hit.tokens_matched              # includes the partial frac
            frac = hit.partial_len
            sfx = seq[L:]
            S = int(sfx.shape[0])              # >= 1 by _prefix_tokens' cap
            # clamp so shared rows + merged suffix pages never outrun the
            # page table
            bucket = min(self.bucket(S), self.max_len - L)
            key = (bucket, L)
            prefill = self._prefills.get(key)
            if prefill is None:
                prefill = self.container.compile_serve_step(
                    "prefill_slot_paged", prompt_len=bucket,
                    page_size=self.page_size, prefix_len=L,
                    n_pages=self.n_pages)
                self._prefills[key] = prefill
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :S] = sfx
            self.pool.reserve(slot, self.pages_needed(req) - k)
            self.pool.share_chain(slot, hit)    # restores spilled nodes
            self.pool.alloc_upto(slot, P - 1)   # private suffix pages
            self._drain_tier_events(req.rid, tick)
            t0 = time.perf_counter()
            first, small = prefill(
                self.params, self.cache, self._ids(toks), S,
                self._ids([n.page for n in hit.all_nodes()]))
            # the suffix prefill READS the live pool and the scatter below
            # WRITES it; both run in order on the device's stream, and
            # ``small`` already holds its copy of the boundary page
            first = int(first[0])
            self.pool.unpin()   # partial boundary page consumed by small
            np_ = -(-(frac + bucket) // self.page_size)
            row = self._ids(self.pool.table[slot, k:k + np_])
            self.cache = _insert_pages(self.cache, small, row)
            start_pos = P
            toks_p = self._prefix_tokens(req)
            kc = len(toks_p) // self.page_size  # declared complete blocks
            if k >= 1:
                self._c_phits.inc()
                if k < kc:
                    # shared a shorter family's ancestor chain, not the
                    # whole declared prefix -- the radix win over the flat
                    # index, accounted apart for fig11
                    self._c_pancestor.inc()
            else:
                self._c_ppartial.inc()
            self.metrics.counter("prefix_hit_depth", replica=self.name,
                                 depth=str(k)).inc()
            self._c_psaved.inc(L)
            self._c_positions.inc(S)
            self._c_prefill_disp.inc()
            if kc > k:
                # ancestor hit: deepen the family by registering the
                # freshly-written complete declared blocks BELOW the
                # matched chain (interior promotion; a partial boundary
                # implies kc == k, nothing to register)
                ps = self.page_size
                self.pool.promote_chain(
                    slot, hit.nodes[-1] if hit.nodes else None,
                    [toks_p[i * ps:(i + 1) * ps] for i in range(k, kc)])
            self.prefill_s += time.perf_counter() - t0
            self.trace.record(req.rid, "prefill", tick, replica=self.name,
                              slot=slot, positions=S, bucket=bucket,
                              pages=self.pages_needed(req) - k,
                              prefix_hit=True, tokens_saved=L,
                              depth=k, partial=frac)
        else:
            bucket = self.bucket(P)
            prefill = self._prefills.get(bucket)
            if prefill is None:
                shapes = ({"page_size": self.page_size} if self.paged
                          else {"cache_len": self.max_len})
                if self.fe_len:
                    shapes["frontend_len"] = self.fe_len
                prefill = self.container.compile_serve_step(
                    *(("prefill_slot_paged",) if self.paged
                      else ("prefill_slot",)),
                    prompt_len=bucket, **shapes)
                self._prefills[bucket] = prefill
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :P] = seq
            t0 = time.perf_counter()
            first, small = prefill(self.params, self._ids(toks), P)
            start_pos = req.frontend_len + P
            if self.paged:
                # bulk prefix+prompt allocation, then one page-major scatter
                self.pool.reserve(slot, self.pages_needed(req))
                self.pool.alloc_upto(slot, start_pos - 1)
                np_ = -(-(bucket + self.fe_len) // self.page_size)
                row = self._ids(self.pool.table[slot, :np_])
                self.cache = _insert_pages(self.cache, small, row)
            else:
                self.cache = self._insert(self.cache, small, slot)
            first = int(first[0])
            self.prefill_s += time.perf_counter() - t0
            self._c_positions.inc(req.frontend_len + P)
            self._c_prefill_disp.inc()
            if self.paged:
                # spills triggered by this allocation, recorded BEFORE the
                # prefill span (spill precedes prefill in SPAN_TRANSITIONS)
                self._drain_tier_events(req.rid, tick)
            self.trace.record(req.rid, "prefill", tick, replica=self.name,
                              slot=slot, positions=req.frontend_len + P,
                              bucket=bucket,
                              pages=(self.pages_needed(req) if self.paged
                                     else 0),
                              prefix_hit=False)
            toks_p = self._prefix_tokens(req)
            if toks_p is not None:
                # MISS: promote the freshly-written, fully-covered leading
                # prompt pages into the registry as a chain of nodes -- one
                # per complete declared block -- so later requests share
                # ANY ancestor of them (first writer wins; an existing
                # child or digest collision stops the chain there).
                # _prefix_tokens caps at prompt_len - 1, so the page
                # holding the first suffix token stays private: promoting
                # an uncapped prefix_len // page_size used to cache a page
                # no match could ever reach, pinned until eviction (leak)
                ps = self.page_size
                kc = len(toks_p) // ps
                if kc >= 1:
                    self._c_pmiss.inc()
                    self.pool.promote_chain(
                        slot, None,
                        [toks_p[i * ps:(i + 1) * ps] for i in range(kc)])

        if resuming:
            # the prefill re-sampled the token after seq's last element --
            # a recomputation of tokens[-1]. The original sample is
            # authoritative; keeping it as the decode cursor makes the
            # resumed run bitwise-continue the unpreempted one.
            self.pos[slot] = start_pos
            self.cur_tok[slot] = req.tokens[-1]
            self.active[slot] = req
            return False
        req.tokens.append(first)
        self._c_tokens.inc()
        self.pos[slot] = start_pos      # next decode writes here
        self.cur_tok[slot] = first
        self.active[slot] = req
        if self._finished(req, first):
            self._complete(req, tick)
            return True
        return False

    # -- decode -------------------------------------------------------------
    def tick(self, tick: int) -> list[GenRequest]:
        """One decode *chunk* (``self.chunk`` model ticks in one dispatch)
        over the whole slot bank; returns requests that completed. A slot
        finishing mid-chunk decodes to the chunk boundary; its surplus
        tokens are discarded here (bounded, counted waste)."""
        if not self.active:
            return []
        t0 = time.perf_counter()
        if self.paged:
            # alloc-on-write, one chunk ahead: every write position of this
            # dispatch (pos..pos+chunk-1) must be mapped before the kernel
            # runs; pages come out of the request's admission reservation,
            # so this can never fail mid-flight
            for slot in self.active:
                self.pool.alloc_upto(slot, int(self.pos[slot]) + self.chunk - 1)
                self._drain_tier_events(self.active[slot].rid, tick)
            toks, _, _, self.cache = self.decode(
                self.params, self.cache,
                self._ids(self.cur_tok[:, None]), self._ids(self.pos),
                self._ids(self.pool.table))
        else:
            toks, _, _, self.cache = self.decode(
                self.params, self.cache,
                self._ids(self.cur_tok[:, None]), self._ids(self.pos))
        toks = toks.cpu().numpy()                       # (n_slots, chunk)
        self.decode_s += time.perf_counter() - t0
        self._c_decode_ticks.inc(self.chunk)
        self._c_decode_disp.inc()

        finished = []
        # advance ACTIVE rows only: free slots stay parked at 0, so an
        # engine idling for hours never walks a row position past max_len
        # (in paged mode pos // page_size would index past the page-table
        # span -- silently clamped by XLA, out-of-bounds for the real
        # scalar-prefetch kernel)
        for slot in self.active:
            self.pos[slot] += self.chunk
        for slot, req in list(self.active.items()):
            self.cur_tok[slot] = int(toks[slot, -1])
            self.trace.record(req.rid, "decode_chunk", tick,
                              replica=self.name, slot=slot, chunk=self.chunk)
            for k in range(self.chunk):
                tok = int(toks[slot, k])
                req.tokens.append(tok)
                self._c_tokens.inc()
                if self._finished(req, tok):
                    # the rest of the chunk decoded past the finish: those
                    # tokens are discarded -- count the waste
                    self._c_wasted.inc(self.chunk - 1 - k)
                    self._complete(req, tick)
                    finished.append(req)
                    break
        return finished

    def _finished(self, req: GenRequest, tok: int) -> bool:
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        if eos is not None and tok == eos:
            req.finish_reason = "eos"
            return True
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _complete(self, req: GenRequest, tick: int) -> None:
        req.state, req.done_tick = "done", tick
        self.trace.record(req.rid, "complete", tick, replica=self.name,
                          slot=req.slot, tokens=len(req.tokens),
                          reason=req.finish_reason)
        self.active.pop(req.slot)
        self.free.append(req.slot)
        self._c_slots_freed.inc()
        # park the freed row at position 0: free slots are still dispatched
        # every chunk (their output is discarded), so an unbounded position
        # would drift past the cache span while the slot sits idle
        self.pos[req.slot] = 0
        self.cur_tok[req.slot] = 0
        if self.paged:
            # full reclaim the same tick: owned pages + unused reservation
            self.pool.release(req.slot)

    def preempt(self, req: GenRequest, tick: int) -> int:
        """Page-level preemption: pause ``req`` mid-decode and reclaim its
        slot plus every private page and unfilled reservation, making room
        for a higher-priority admission. The generated-so-far tokens stay
        on the request; ``start`` later resumes it by re-prefilling them as
        a suffix. Returns the number of owned pages freed."""
        if not self.paged:
            raise RuntimeError(
                f"engine {self.name}: preemption is page-granular "
                "(paged mode only)")
        slot = req.slot
        if self.active.get(slot) is not req:
            raise RuntimeError(
                f"request {req.rid} is not running on engine {self.name}")
        freed = self.pool.pause(slot)
        self.active.pop(slot)
        self.free.append(slot)
        self._c_slots_freed.inc()
        self.pos[slot] = 0              # park like _complete: free slots
        self.cur_tok[slot] = 0          # are still dispatched every chunk
        req.state, req.slot, req.replica = "preempted", None, None
        req.preemptions += 1
        self._c_preempted.inc()
        self.trace.record(req.rid, "preempt", tick, replica=self.name,
                          slot=slot, pages_freed=freed,
                          tokens_done=len(req.tokens))
        return freed

    def release(self) -> None:
        """Drop device state (params, slot cache, executables). Called at
        retirement so upgraded-away fleets do not pin a whole generation of
        params+KV in device memory."""
        self.stopped = True
        self.params = None
        self.cache = None
        self.decode = None
        self._prefills.clear()

    def status(self) -> dict:
        out = {
            "container": self.container.container_id,
            "image": self.container.image.short_digest,
            "slots": self.n_slots,
            "active": len(self.active),
            "free": len(self.free),
            "draining": self.draining,
            "stopped": self.stopped,
            "decode_ticks": self.decode_ticks,
            "tokens_generated": self.tokens_generated,
            "tokens_wasted": self.tokens_wasted,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            # one compiled prefill per distinct bucket -- bounded for
            # pow2-bucketed archs, per distinct prompt length in
            # exact-prefill mode (watch this in `ps` for unbounded growth)
            "prefill_execs": len(self._prefills),
        }
        compile_stats = getattr(self.container, "serve_compile_stats", None)
        if compile_stats:
            out["compile"] = dict(compile_stats)
        if self.paged:
            out["pool"] = self.pool.status()
            if self.prefix_cache:
                out["prefix_cache"] = {
                    "hits": self.prefix_hits,
                    "misses": self.prefix_misses,
                    "tokens_saved": self.prefix_tokens_saved,
                    "shared_pages": self.pool.cached_pages,
                    "ancestor_hits": self.prefix_ancestor_hits,
                    "partial_hits": self.prefix_partial_hits,
                    "nodes": self.pool.radix.node_count,
                    "max_depth": self.pool.radix.max_depth,
                    "spilled_pages": self.pool.spilled_pages,
                    "spills": self.pool.spills,
                    "restores": self.pool.restores,
                }
        return out


class ContinuousScheduler:
    """Iteration-level scheduling over a Pod's engines."""

    STATE_EVERY = 8     # min ticks between pod-state file refreshes

    def __init__(self, pod, queue: RequestQueue | None = None,
                 fairness_cap: int = 4):
        self.pod = pod
        self.queue = queue or RequestQueue()
        self.fairness_cap = int(fairness_cap)
        self.tick = 0
        self._state_tick = -self.STATE_EVERY
        self.completed: list[GenRequest] = []
        self.rejected: list[GenRequest] = []
        self.shedded: list[GenRequest] = []
        self.admission_order: list[int] = []
        # pod-level completion metrics, registered eagerly so an idle pod
        # still snapshots the full (empty) shape; geometry shared with
        # obs.report so the span-log recompute compares field-for-field
        self.metrics = getattr(pod, "metrics", None) or MetricsRegistry()
        self.trace = getattr(pod, "trace", None) or TraceBuffer()
        self._c_completed = self.metrics.counter("requests_completed")
        self._c_rejected = self.metrics.counter("requests_rejected")
        self._c_shed = self.metrics.counter("requests_shed")
        self._c_tokens_out = self.metrics.counter("tokens_out")
        self._g_queue = self.metrics.gauge("queue_depth")
        self.metrics.histogram("latency_ticks", **TICK_HIST)
        self.metrics.histogram("ttft_ticks", **TICK_HIST)
        self.metrics.histogram("itl_milliticks", **ITL_HIST)

    def submit(self, reqs: Iterable[GenRequest] | GenRequest) -> None:
        if isinstance(reqs, GenRequest):
            reqs = [reqs]
        for r in reqs:
            self.queue.submit(r, self.tick)
            self.trace.record(r.rid, "submit", self.tick, arrival=r.arrival)
        self._g_queue.set(self.queue.pending)

    def reject(self, req: GenRequest) -> None:
        """Terminal rejection: record the per-engine reasons and count it
        where ``Pod.status`` / ``repro ps`` can see it."""
        req.state, req.finish_reason = "rejected", "oversized"
        req.error = "; ".join(sorted(
            {e.reject_reason(req) for e in self.pod.engines}))
        req.done_tick = self.tick
        self.rejected.append(req)
        self.pod.rejected += 1
        self._c_rejected.inc()
        self.trace.record(req.rid, "reject", self.tick, reason="oversized")

    def shed(self, req: GenRequest, reason: str) -> None:
        """Typed QoS shed: terminal like a rejection, but counted apart --
        the request was servable, the SLO policy chose not to serve it."""
        req.state, req.finish_reason = "shed", reason
        req.error = (f"shed: admission deadline of {req.deadline_ticks} "
                     f"ticks missed" if reason == "deadline"
                     else f"shed: {reason}")
        req.done_tick = self.tick
        self.shedded.append(req)
        self.pod.shed += 1
        self._c_shed.inc()
        self.trace.record(req.rid, "shed", self.tick, reason=reason,
                          priority=req.priority)

    # -- one global tick ------------------------------------------------------
    def step(self) -> list[GenRequest]:
        done: list[GenRequest] = []
        # admission: FIFO across the pod, capped prefills per tick
        admitted = rejected = 0
        while admitted < self.fairness_cap and self.queue.has_ready(self.tick):
            req = self.queue.peek_ready(self.tick)
            # permanent infeasibility is screened BEFORE the free-slot gate:
            # a request that exceeds every engine's slab / page-table span /
            # pool can NEVER run, so it must be rejected even when all slots
            # are busy -- gating on occupancy let an un-servable head stall
            # every feasible request behind it until a slot freed
            if not any(e.fits(req) for e in self.pod.engines):
                self.queue.pop_ready(self.tick)
                self.reject(req)
                rejected += 1
                continue
            # admission-deadline SLO: a queued head that can no longer be
            # admitted in time is shed, not served uselessly late. Resumes
            # are exempt -- their first token already left on time.
            if (req.state == "queued" and req.deadline_ticks is not None
                    and self.tick > max(req.arrival, req.submit_tick)
                    + req.deadline_ticks):
                self.queue.pop_ready(self.tick)
                self.shed(req, "deadline")
                rejected += 1
                continue
            engines = [e for e in self.pod.engines if e.has_free()]
            ready = [e for e in engines if e.can_start(req)]
            if not ready:
                # feasible but no slot / no pages free right now: hold the
                # head -- unless it is an interactive head blocked behind
                # running batch work, in which case page-level preemption
                # pauses the youngest batch request to make room (strict
                # QoS; equal-priority work is never preempted)
                if self._try_preempt(req):
                    continue
                break
            # least-loaded engine keeps replica occupancy balanced without
            # breaking FIFO (the *request* order is still queue order);
            # an engine whose registry already holds the request's prefix
            # wins ties-or-better, DEEPEST match first (prefix affinity
            # WITHIN the pod -- each replica's page pool is its own)
            def _affinity(e):
                m = e.prefix_hit(req)
                return (-m.tokens_matched if m is not None else 0,
                        len(e.active))
            eng = min(ready, key=_affinity)
            self.queue.pop_ready(self.tick)
            if req.state == "queued":   # resumes were already counted
                self.queue.admitted += 1
                self.admission_order.append(req.rid)
            if eng.start(req, self.tick):
                done.append(req)
            admitted += 1
        # decode: every engine advances its active slots by one token
        for eng in self.pod.engines:
            done.extend(eng.tick(self.tick))
        self.completed.extend(done)
        for req in done:
            self._observe(req)
        self._g_queue.set(self.queue.pending)
        self.tick += 1
        # keep `repro ps` honest without putting file I/O in every tick:
        # refresh on occupancy OR rejection changes, at most once per
        # STATE_EVERY ticks -- a burst of pure rejections used to leave the
        # state file (queue depth, rejected counter) stale indefinitely
        if (admitted or done or rejected) and (
                self.tick - self._state_tick >= self.STATE_EVERY):
            self.pod.write_state()
            self._state_tick = self.tick
        return done

    def _try_preempt(self, req: GenRequest) -> bool:
        """Page-level preemption on behalf of a blocked interactive head:
        pause ONE running batch request (on a paged engine that could fit
        ``req``), releasing its slot, private pages and reservation, and
        requeue it at the front of the batch lane for a later resume.
        Victim choice is deterministic: the most recently admitted batch
        request (ties by rid) -- the least decode progress thrown away.
        Returns True if a victim was paused (the admission loop retries the
        head), False if there is nothing to preempt."""
        if req.priority != "interactive":
            return False
        victims = [(e, r) for e in self.pod.engines
                   if e.paged and not e.draining and e.fits(req)
                   for r in e.active.values() if r.priority == "batch"]
        if not victims:
            return False
        eng, victim = max(victims,
                          key=lambda t: (t[1].admit_tick, t[1].rid))
        eng.preempt(victim, self.tick)
        self.queue.requeue(victim)
        return True

    def _observe(self, req: GenRequest) -> None:
        """Feed one completion into the pod registry. Shares the formulas
        with ``obs.report.observe_completion`` so metrics recomputed from
        the span log bitwise-match this registry's snapshot."""
        observe_completion(
            self.metrics, arrival=req.arrival, submit_tick=req.submit_tick,
            admit_tick=req.admit_tick, done_tick=req.done_tick,
            n_tokens=len(req.tokens), rid=req.rid)

    @property
    def busy(self) -> bool:
        return (self.queue.pending > 0
                or any(e.active for e in self.pod.engines))

    def run(self, max_ticks: int | None = None) -> list[GenRequest]:
        """Serve until queue + slots are empty (or ``max_ticks``)."""
        start = self.tick
        while self.busy:
            if max_ticks is not None and self.tick - start >= max_ticks:
                break
            self.step()
        self.pod.write_state()      # final snapshot (throttle may have skipped)
        return self.completed

    def drain(self, engine: SlotEngine, max_ticks: int = 100_000,
              tick_fn=None) -> int:
        """Tick until ``engine`` has no in-flight requests. The engine is
        marked draining (no new admissions) but its active requests run to
        completion; other engines keep serving. ``tick_fn`` overrides the
        tick driver -- the fleet deployer passes ``PodRouter.step`` so the
        OTHER pods keep admitting and decoding while this one drains."""
        engine.draining = True
        tick_fn = tick_fn or self.step
        ticks = 0
        while engine.active and ticks < max_ticks:
            tick_fn()
            ticks += 1
        if engine.active:
            raise RuntimeError(
                f"drain of {engine.name} did not converge in {max_ticks} ticks")
        return ticks
