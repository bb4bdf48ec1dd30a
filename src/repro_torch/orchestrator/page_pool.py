"""PagePool: host-side block allocator for the paged KV cache.

The device holds one global pool per layer, ``(n_kv, n_pages, page_size,
hd)``; this class owns the free-list and the per-slot page table that maps
logical positions to physical pages. All bookkeeping is host numpy -- the
only device traffic it generates is the (n_slots, max_pages) int32 table
shipped with each decode dispatch, plus the spill/restore page copies its
registered callbacks perform.

Allocation protocol (reservation-based, preempt-free):

  * ``reserve(slot, n)`` at ADMISSION sets aside the request's worst-case
    page count (ceil((prompt + budget + chunk) / page_size)). Admission is
    gated on ``can_reserve`` -- the pool never over-commits, so a running
    request can never fail to get a page mid-decode and nothing is ever
    preempted. Backpressure = the scheduler simply stops admitting.
  * ``alloc_upto(slot, hi)`` is the lazy ALLOC-ON-WRITE: physical pages are
    pulled from the free-list only when decode is about to write position
    ``hi`` (prefill bulk-allocates the prompt's pages the same way). A
    request that exits early (EOS) therefore returns its never-written
    reserved pages without them ever leaving the free-list.
  * ``release(slot)`` at COMPLETION returns owned pages and the remaining
    reservation in one step and resets the table row.
  * ``pause(slot)`` is page-level PREEMPTION: the same full reclaim as
    ``release`` (private pages freed, reservation returned, shared pages
    decref'd) but the slot is marked *paused* -- ``check()`` pins that a
    paused slot holds nothing until a later ``reserve`` (the resume's
    suffix re-prefill) clears the flag.

Prefix registry (the container-image model: content-addressed layers shared
by every image stacked on them, re-pulled from the registry by digest when
evicted):

  * the prefix index is a RADIX TREE over page-aligned blocks
    (``prefix_registry.PrefixRadix``): one node per block, keyed by a
    chained digest, so "system prompt + few-shot examples" requests share
    the ancestor pages of plain "system prompt" requests instead of each
    family caching a disjoint whole-prefix entry;
  * ``match`` walks the tree for the longest registered ancestry --
    including a PARTIAL in-node match when the declared prefix ends
    mid-block (the boundary page becomes a read-only merge operand for the
    suffix prefill's first private page);
  * ``share_chain`` maps the matched chain into a slot's leading table rows
    (refcount per mapping) and restores any spilled chain node first;
    ``promote_chain`` registers a slot's freshly-written leading pages as
    new nodes, every complete block individually -- interior promotion
    grows existing families deeper;
  * under pool pressure ``_take_page`` SPILLS the LRU refcount-0 node
    (leaf-first, ties broken by digest so eviction order is deterministic):
    the page contents move to the host-RAM ``SpillStore`` keyed by node
    digest and the device page returns to the free-list; the node survives
    with ``page=None``. A later ``share_chain`` pulls it back by digest --
    a registry pull instead of a re-prefill. With the spill tier disabled
    (``spill_pages=0``) pressure falls back to true eviction.

``free_unreserved`` generalizes to ``free + evictable - unfilled promises``
so admission can count reclaimable refcount-0 cached pages as headroom
while never breaking an outstanding reservation. ``pin_cost`` dedupes by
page id, so a page reachable through several match nodes is only budgeted
once and admission never under-counts its headroom.

Page 0 is reserved as the *garbage page*: table rows reset to 0, so device
scatters/gathers through free or not-yet-extended slots land on a real page
whose contents are never read unmasked. ``capacity`` excludes it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.orchestrator.obs.metrics import MetricsRegistry
from repro_torch.orchestrator.prefix_registry import (PrefixMatch, PrefixRadix,
                                                RadixNode, SpillStore)

GARBAGE_PAGE = 0


class PagePool:
    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages: int, *, metrics: MetricsRegistry | None = None,
                 replica: str | None = None,
                 spill_pages: int | None = 0):
        if n_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is garbage)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        self.free: list[int] = list(range(1, self.n_pages))
        self.table = np.full((self.n_slots, self.max_pages), GARBAGE_PAGE,
                             np.int32)
        self.owned: list[list[int]] = [[] for _ in range(self.n_slots)]
        # leading table rows mapped to SHARED (cached) pages; a slot's table
        # is always [shared rows, owned rows, garbage...]
        self.shared: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.reserved = np.zeros(self.n_slots, np.int64)
        # per-page count of slot mappings (shared rows only; owned pages are
        # exclusively held, cached pages at refcount 0 are evictable)
        self.refcount = np.zeros(self.n_pages, np.int64)
        # the prefix registry: radix tree of page blocks + host spill tier.
        # spill_pages: 0 disables the tier (pressure evicts), None leaves it
        # unbounded, > 0 caps resident payloads (LRU subtrees pruned past it)
        self.radix = PrefixRadix(self.page_size)
        self.spill_enabled = spill_pages is None or spill_pages > 0
        self.store = SpillStore(capacity=spill_pages
                                if self.spill_enabled else 0)
        # digests pinned against spill/eviction/pruning between share_chain
        # and unpin(): the partial boundary node is read by the suffix
        # prefill AFTER the pool ops that could otherwise reclaim it
        self._pinned: set[str] = set()
        # device-side page movers, registered by the owning engine; absent
        # (pure-host tests) the payload is a bookkeeping stub
        self._spill_save = None
        self._spill_load = None
        # (kind, digest) spill/restore events since the last drain -- the
        # engine turns them into trace spans under the triggering request
        self.events: list[tuple[str, str]] = []
        # slots paused by page-level preemption: all pages reclaimed, the
        # owning request waits queued for resume (check() pins emptiness)
        self.paused: set[int] = set()
        self._clock = 0
        # accounting (status + the fig7/fig9/fig11 benchmarks) lives in the
        # shared registry (the pod's when embedded, a private one
        # standalone); the old attribute names survive below as read-only
        # property shims. "pool_"-prefixed names keep pool prefix-hits/
        # evictions distinct from the engine-level counters of the same
        # concept.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        labels = {"replica": replica} if replica is not None else {}
        self._c_alloc = self.metrics.counter("pages_allocated", **labels)
        self._c_freed = self.metrics.counter("pages_freed", **labels)
        self._c_evict = self.metrics.counter("pool_evictions", **labels)
        self._c_cow = self.metrics.counter("cow_copies", **labels)
        self._c_phits = self.metrics.counter("pool_prefix_hits", **labels)
        self._c_paused = self.metrics.counter("pool_preemptions", **labels)
        self._c_spill = self.metrics.counter("pool_spills", **labels)
        self._c_restore = self.metrics.counter("pool_restores", **labels)
        self._g_in_use = self.metrics.gauge("pool_in_use", **labels)

    # registry-backed shims for the pre-registry attribute names
    @property
    def pages_allocated(self) -> int:
        return self._c_alloc.value

    @property
    def pages_freed(self) -> int:
        return self._c_freed.value

    @property
    def evictions(self) -> int:
        return self._c_evict.value

    @property
    def cow_copies(self) -> int:
        return self._c_cow.value

    @property
    def prefix_hits(self) -> int:
        return self._c_phits.value

    @property
    def spills(self) -> int:
        return self._c_spill.value

    @property
    def restores(self) -> int:
        return self._c_restore.value

    @property
    def peak_in_use(self) -> int:
        return self._g_in_use.high

    # -- device IO hooks ----------------------------------------------------
    def set_spill_io(self, save, load) -> None:
        """Register the device-side page movers: ``save(page) -> payload``
        copies a pool page to host, ``load(page, payload)`` writes one
        back. Without them (pure-host tests) spilled payloads are stubs --
        the bookkeeping is identical either way."""
        self._spill_save = save
        self._spill_load = load

    def drain_events(self) -> list[tuple[str, str]]:
        """Spill/restore events since the last drain, oldest first. The
        engine records them as trace spans attributed to the request whose
        allocation triggered the tier movement."""
        out = self.events
        self.events = []
        return out

    # -- capacity -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (garbage page excluded)."""
        return self.n_pages - 1

    @property
    def total_reserved(self) -> int:
        return int(self.reserved.sum())

    @property
    def total_owned(self) -> int:
        return sum(len(o) for o in self.owned)

    @property
    def cached_pages(self) -> int:
        """Pages resident in the prefix registry (shared or warm)."""
        return sum(1 for n in self.radix.walk() if n.resident)

    @property
    def spilled_pages(self) -> int:
        """Registry nodes currently in the host spill tier."""
        return len(self.store)

    def _node_evictable(self, node: RadixNode) -> bool:
        return (node.resident and self.refcount[node.page] == 0
                and node.digest not in self._pinned)

    @property
    def evictable_pages(self) -> int:
        """Cached pages with no live sharers -- reclaimable under pressure.
        Counted as a SET of page ids: a page reachable through more than
        one node must not inflate the reclaimable headroom."""
        return len({n.page for n in self.radix.walk()
                    if self._node_evictable(n)})

    @property
    def free_unreserved(self) -> int:
        """Headroom for NEW reservations: free + evictable cached pages,
        minus pages already promised to admitted requests but not yet drawn
        (the promise invariant ``check`` pins)."""
        unfilled = self.total_reserved - self.total_owned
        return len(self.free) + self.evictable_pages - unfilled

    def pages_for(self, positions: int) -> int:
        """Pages needed to cover ``positions`` KV positions."""
        return -(-int(positions) // self.page_size)

    def can_reserve(self, n: int) -> bool:
        return n <= self.free_unreserved

    def pin_cost(self, m: PrefixMatch) -> int:
        """Extra headroom a ``share_chain`` of ``m`` consumes: pinning the
        currently-evictable nodes of the chain (partial boundary included)
        removes their pages from the evictable set, so admission must
        budget them like an allocation. Deduped BY PAGE ID -- a page
        referenced by more than one match node counts once, else admission
        under-admits under heavy sharing."""
        return len({n.page for n in m.all_nodes()
                    if self._node_evictable(n)})

    def restore_cost(self, m: PrefixMatch) -> int:
        """Free pages a ``share_chain`` of ``m`` must draw to pull spilled
        chain nodes (partial boundary included) back from the host tier."""
        return sum(1 for n in m.all_nodes() if not n.resident)

    # -- allocation ---------------------------------------------------------
    def reserve(self, slot: int, n: int) -> None:
        if self.reserved[slot] or self.owned[slot] or self.shared[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        if not self.can_reserve(n):
            raise RuntimeError(
                f"cannot reserve {n} pages: {self.free_unreserved} unreserved")
        # a paused slot coming back through reserve IS the resume: the
        # suffix re-prefill re-books its worst case like a fresh admission
        self.paused.discard(slot)
        self.reserved[slot] = n

    def _victims(self) -> list[RadixNode]:
        """Reclaimable nodes in eviction order: resident, refcount 0,
        unpinned, with no resident children (leaf-first, so removing or
        spilling one never strands a resident descendant), sorted by
        (last_used, digest) -- the digest tie-break keeps eviction order
        deterministic when several nodes share a last-use tick."""
        out = [n for n in self.radix.walk()
               if self._node_evictable(n)
               and not any(c.resident for c in n.children.values())]
        out.sort(key=lambda n: (n.last_used, n.digest))
        return out

    def _take_page(self) -> int:
        """One page off the free-list, spilling (or, with the tier
        disabled, evicting) LRU refcount-0 registry nodes under pressure.
        Never touches a page with live refs or a pinned digest."""
        while not self.free:
            victims = self._victims()
            if not victims:
                raise RuntimeError(
                    "page pool exhausted: no free pages and every cached "
                    "prefix has live sharers")
            self._spill_or_evict(victims[0])
        return self.free.pop()

    def _spill_or_evict(self, node: RadixNode) -> None:
        if self.spill_enabled:
            payload = (self._spill_save(node.page)
                       if self._spill_save is not None
                       else ("stub", node.digest))
            self.store.put(node.digest, payload)
            self.free.append(node.page)
            node.page = None
            self._c_freed.inc()
            self._c_spill.inc()
            self.events.append(("spill", node.digest))
            self._g_in_use.set(self.in_use)
            self._enforce_store_capacity()
        else:
            self._evict_node(node)

    def _evict_node(self, node: RadixNode) -> None:
        """True eviction of a resident leaf node: page freed, node gone."""
        assert self._node_evictable(node), "evicting a live/pinned node"
        assert not node.children, "evicting an interior node"
        self.free.append(node.page)
        node.page = None
        self.radix.remove(node)
        self._c_freed.inc()
        self._c_evict.inc()
        self._g_in_use.set(self.in_use)

    def _restore_node(self, node: RadixNode) -> None:
        """Registry pull: draw a free page and re-materialize a spilled
        node's contents from the host tier by digest."""
        assert not node.resident, "restoring a resident node"
        page = self._take_page()
        payload = self.store.pop(node.digest)
        if self._spill_load is not None:
            self._spill_load(page, payload)
        node.page = page
        self._c_alloc.inc()
        self._c_restore.inc()
        self.events.append(("restore", node.digest))
        self._g_in_use.set(self.in_use)

    def _enforce_store_capacity(self) -> None:
        """Prune LRU spilled subtrees past the host-tier budget. A pruned
        node's descendants are all spilled too (resident needs a resident
        parent), so whole subtrees leave the registry together. Pinned
        chains are skipped -- they are mid-restore and will leave the
        store on their own."""
        while self.store.over_capacity:
            by_digest = {n.digest: n for n in self.radix.walk()
                         if not n.resident}
            pruned = False
            for d in self.store.lru_digests():
                node = by_digest[d]
                sub = self.radix.subtree(node)
                if any(n.digest in self._pinned for n in sub):
                    continue
                for n in reversed(sub):
                    assert not n.resident, "pruning a resident node"
                    self.store.discard(n.digest)
                    self.radix.remove(n)
                    self._c_evict.inc()
                pruned = True
                break
            if not pruned:
                break

    def alloc_upto(self, slot: int, hi: int) -> None:
        """Ensure pages cover logical positions [0, hi] for ``slot``.
        Shared rows count toward coverage; only private (owned) pages are
        drawn from the free-list."""
        need = self.pages_for(hi + 1)
        base = len(self.shared[slot])
        have = base + len(self.owned[slot])
        if need <= have:
            return
        if need - base > self.reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: {need - base} private pages exceeds "
                f"reservation {int(self.reserved[slot])}")
        for j in range(have, need):
            page = self._take_page()
            self.owned[slot].append(page)
            self.table[slot, j] = page
            self._c_alloc.inc()
        self._g_in_use.set(self.in_use)

    def release(self, slot: int) -> None:
        """Full reclaim of PRIVATE state: owned pages and the remaining
        reservation return; shared pages are only decref'd -- they belong
        to the prefix registry and possibly to other sharers' table rows,
        so freeing them here would let a reallocation clobber a live
        prefix."""
        pages = self.owned[slot]
        self.free.extend(pages)
        self._c_freed.inc(len(pages))
        self.owned[slot] = []
        for p in self.shared[slot]:
            self.refcount[p] -= 1
        self.shared[slot] = []
        self.reserved[slot] = 0
        self.table[slot, :] = GARBAGE_PAGE
        self.paused.discard(slot)
        self._g_in_use.set(self.in_use)

    def pause(self, slot: int) -> int:
        """Page-level preemption of ``slot``: reclaim its private pages and
        unfilled reservation (and decref its shared mappings) exactly like
        ``release``, then mark the slot paused. Returns the number of pages
        returned to the free-list. The paused mark is bookkeeping for
        ``check()`` -- a paused slot must hold NOTHING until its resume
        re-reserves -- and clears on the next ``reserve`` or ``release``."""
        if not (self.reserved[slot] or self.owned[slot] or self.shared[slot]):
            raise RuntimeError(f"slot {slot} has nothing to preempt")
        freed = len(self.owned[slot])
        self.release(slot)
        self.paused.add(slot)
        self._c_paused.inc()
        return freed

    # -- prefix registry ----------------------------------------------------
    def match(self, tokens: np.ndarray, touch: bool = False) -> PrefixMatch:
        """Longest registered ancestry of ``tokens`` (see
        ``PrefixRadix.match``): fully-matched whole blocks plus an optional
        partial in-node boundary. Token blocks are compared byte-for-byte
        during the walk, so a chained-digest collision over different
        tokens stops the match instead of serving someone else's layer."""
        m = self.radix.match(tokens)
        if touch and m.all_nodes():
            for n in m.all_nodes():
                self._clock += 1
                n.last_used = self._clock
        return m

    def share_chain(self, slot: int, m: PrefixMatch) -> None:
        """Map the matched chain's pages into ``slot``'s leading table rows
        (refcount per mapping), pulling any spilled chain node back from
        the host tier first -- parents before children, so the resident
        subtree stays rooted. The partial boundary node (if any) is
        restored and PINNED but not mapped: the suffix prefill reads it as
        a merge operand and the engine calls ``unpin`` once that read is
        done. Must precede any private allocation for the slot."""
        if self.shared[slot] or self.owned[slot]:
            raise RuntimeError(f"slot {slot} already has mapped pages")
        chain = m.all_nodes()
        if not chain:
            raise ValueError("share_chain of an empty match")
        # pinning currently-evictable nodes shrinks the evictable set and
        # restores draw free pages: enforce the preempt-free promise HERE,
        # not just in the admission caller (can_start budgets pin_cost +
        # restore_cost before reserving; any other call path must too)
        need = self.pin_cost(m) + self.restore_cost(m)
        if need and self.free_unreserved < need:
            raise RuntimeError(
                f"sharing would pin/restore {need} pages promised to "
                f"outstanding reservations ({self.free_unreserved} "
                "unreserved)")
        self._pinned.update(n.digest for n in chain)
        pages: list[int] = []
        for n in m.nodes:
            if not n.resident:
                self._restore_node(n)
            self.refcount[n.page] += 1
            self.table[slot, len(pages)] = n.page
            pages.append(n.page)
            self._clock += 1
            n.last_used = self._clock
            n.hits += 1
        if m.partial is not None:
            if not m.partial.resident:
                self._restore_node(m.partial)
            self._clock += 1
            m.partial.last_used = self._clock
            m.partial.hits += 1
        self.shared[slot] = pages
        self._c_phits.inc()
        self._g_in_use.set(self.in_use)

    def unpin(self) -> None:
        """Release the spill/eviction pins taken by ``share_chain``. The
        engine calls this once the suffix prefill has consumed the chain
        (mapped rows stay protected by their refcounts; the partial
        boundary page becomes reclaimable again)."""
        self._pinned.clear()
        self._enforce_store_capacity()

    def promote_chain(self, slot: int, parent: RadixNode | None,
                      blocks: list[np.ndarray]) -> list[RadixNode]:
        """Register ``slot``'s leading owned pages as new registry nodes,
        one per complete block, chained under ``parent`` (None = tree
        root). The slot keeps using the pages -- as shared refs now -- and
        its reservation shrinks by one per promoted page since those rows
        no longer draw private pages. First writer wins: an existing child
        (or a digest collision) stops the promotion there, leaving the
        remaining pages private. Returns the nodes created."""
        parent = parent if parent is not None else self.radix.root
        if len(blocks) > len(self.owned[slot]):
            raise ValueError(
                f"promoting {len(blocks)} blocks but slot {slot} owns "
                f"{len(self.owned[slot])} pages")
        promoted: list[RadixNode] = []
        for blk in blocks:
            page = self.owned[slot][0]
            node = self.radix.insert(parent, blk, page)
            if node is None:
                break
            self.owned[slot].pop(0)
            self.shared[slot].append(page)
            self.refcount[page] += 1
            self.reserved[slot] -= 1
            self._clock += 1
            node.last_used = self._clock
            promoted.append(node)
            parent = node
        return promoted

    def spill_one(self) -> str | None:
        """Explicitly move the current eviction victim to the host tier
        (tests and proactive tiering). Returns the spilled node's digest,
        or None when nothing is reclaimable or the tier is disabled."""
        if not self.spill_enabled:
            return None
        victims = self._victims()
        if not victims:
            return None
        node = victims[0]
        digest = node.digest
        self._spill_or_evict(node)
        return digest

    def cow(self, slot: int) -> tuple[int, int]:
        """Copy-on-write the slot's LAST shared table row: remap it to a
        fresh private page and decref the shared one. Returns (old, new)
        physical ids -- the caller copies the device page contents before
        any write. Draws against the slot's reservation."""
        if not self.shared[slot]:
            raise RuntimeError(f"slot {slot} has no shared pages to COW")
        if len(self.owned[slot]) + 1 > self.reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: COW would exceed reservation "
                f"{int(self.reserved[slot])}")
        old = self.shared[slot].pop()
        row = len(self.shared[slot])
        new = self._take_page()
        self.refcount[old] -= 1
        self.owned[slot].insert(0, new)
        self.table[slot, row] = new
        self._c_alloc.inc()
        self._c_cow.inc()
        self._g_in_use.set(self.in_use)
        return old, new

    def drop_prefixes(self) -> int:
        """Flush the registry (tests / explicit reset): every refcount-0
        node leaves, resident pages freed and spilled payloads discarded,
        children before parents. Nodes with live sharers survive (and so
        do their ancestors -- a parent's refcount bounds its children's).
        Returns nodes dropped."""
        n = 0
        for node in reversed(self.radix.walk()):
            if node.children or node.digest in self._pinned:
                continue
            if node.resident:
                if self.refcount[node.page] != 0:
                    continue
                self._evict_node(node)
            else:
                self.store.discard(node.digest)
                self.radix.remove(node)
                self._c_evict.inc()
            n += 1
        return n

    # -- introspection ------------------------------------------------------
    @property
    def in_use(self) -> int:
        """Non-free pages: privately owned + cached (shared or warm)."""
        return self.capacity - len(self.free)

    def check(self) -> None:
        """Invariants; raises AssertionError on any violation. Cheap enough
        to call after every operation in tests."""
        nodes = self.radix.walk()
        self.radix.check()
        owned_all = [p for o in self.owned for p in o]
        cached_all = [n.page for n in nodes if n.resident]
        spilled = [n for n in nodes if not n.resident]
        assert GARBAGE_PAGE not in owned_all, "garbage page was allocated"
        assert GARBAGE_PAGE not in cached_all, "garbage page was cached"
        assert GARBAGE_PAGE not in self.free, "garbage page on free-list"
        assert len(set(owned_all)) == len(owned_all), "page owned twice"
        assert len(set(cached_all)) == len(cached_all), \
            "page cached in two registry nodes"
        assert len(set(self.free)) == len(self.free), "free-list duplicate"
        assert not (set(owned_all) & set(self.free)), "page both owned+free"
        assert not (set(cached_all) & set(self.free)), "page both cached+free"
        assert not (set(owned_all) & set(cached_all)), \
            "page both owned and cached"
        # conservation across tiers: device pages split exactly into
        # free / owned / resident-cached, and the host tier holds exactly
        # the spilled node set (no payload without a node, no spilled node
        # without a payload, never both a page and a payload)
        assert len(self.free) + len(owned_all) + len(cached_all) \
            == self.capacity, "pages leaked or conjured"
        assert self.pages_allocated - self.pages_freed \
            == len(owned_all) + len(cached_all)
        assert self.store.digests() == {n.digest for n in spilled}, \
            "spill store out of sync with spilled registry nodes"
        if not self._pinned:
            assert self.store.over_capacity == 0, \
                "spill store exceeds its capacity with no pinned chains"
        # refcounts == shared-row occurrences, and every shared page is
        # backed by a resident registry node (reclaim requires refcount 0,
        # so a mapped page can never lose its node out from under a sharer)
        refs: dict[int, int] = {}
        for slot, sh in enumerate(self.shared):
            for p in sh:
                refs[p] = refs.get(p, 0) + 1
            assert set(sh) <= set(cached_all), \
                f"slot {slot} shares a page missing from the registry"
        for p in range(self.n_pages):
            assert self.refcount[p] == refs.get(p, 0), \
                f"page {p}: refcount {int(self.refcount[p])} != " \
                f"{refs.get(p, 0)} table occurrences"
        # tree refcount law: every sharer of a child also maps its parent
        # (chains are mapped root-first), so child refcounts sum under the
        # parent's; spilled nodes hold no device page and no sharers
        for n in nodes:
            rc = self.refcount[n.page] if n.resident else 0
            kid_rc = sum(int(self.refcount[c.page])
                         for c in n.children.values() if c.resident)
            assert kid_rc <= rc, \
                f"node {n.digest[:8]}: child refcounts {kid_rc} > {rc}"
            if not n.resident:
                assert n.page is None, "spilled node still holds a page"
        for slot in range(self.n_slots):
            rows = self.shared[slot] + self.owned[slot]
            assert len(self.owned[slot]) <= self.reserved[slot], \
                "allocation > reservation"
            for j, page in enumerate(rows):
                assert self.table[slot, j] == page, "table/rows mismatch"
            assert (self.table[slot, len(rows):] == GARBAGE_PAGE).all(), \
                "table maps unallocated positions"
        assert self.total_reserved <= self.capacity, "pool over-committed"
        # the preempt-free promise: every reserved-but-undrawn page must be
        # coverable by free + evictable pages RIGHT NOW
        unfilled = self.total_reserved - self.total_owned
        assert unfilled <= len(self.free) + self.evictable_pages, \
            "outstanding reservations exceed reclaimable pages"
        # paused (preempted) slots hold NOTHING: their pages were reclaimed
        # at pause time and nothing may creep back before resume re-reserves
        assert self.paused <= set(range(self.n_slots)), "phantom paused slot"
        for slot in sorted(self.paused):
            assert not self.owned[slot] and not self.shared[slot] \
                and not self.reserved[slot], \
                f"paused slot {slot} still holds pages or a reservation"

    def status(self) -> dict:
        return {
            "pages": self.capacity,
            "page_size": self.page_size,
            "in_use": self.in_use,
            "reserved": self.total_reserved,
            "free_unreserved": self.free_unreserved,
            "peak_in_use": self.peak_in_use,
            "cached_pages": self.cached_pages,
            "cached_prefixes": self.radix.node_count,
            "prefix_hits": self.prefix_hits,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "preemptions": self._c_paused.value,
            "paused_slots": len(self.paused),
            "registry": {
                "nodes": self.radix.node_count,
                "resident_pages": self.cached_pages,
                "spilled_pages": self.spilled_pages,
                "max_depth": self.radix.max_depth,
                "spills": self.spills,
                "restores": self.restores,
                "spill_capacity": self.store.capacity
                if self.spill_enabled else 0,
            },
        }
