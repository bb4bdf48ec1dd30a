"""Router tier: one submit()/step()/run() surface over N Pods.

One Pod is one host's replicas; the paper's fleet story (Benedicic et al.'s
Shifter deployments, the HPE adaptive-containerization survey) needs many.
``PodRouter`` fronts N Pods -- each with its own ``ContinuousScheduler``
and ``RequestQueue`` -- behind the same interface a single scheduler
exposes, so drivers, benchmarks and the deployer scale from one pod to a
fleet without changing shape.

Placement is pluggable:

* ``shortest-queue`` (default): route to the pod with the least
  outstanding decode work (committed tokens not yet finished), tie-broken
  by pod order -- load-aware, keeps the fleet evenly packed.
* ``consistent-hash``: hash the request id onto a static ring of virtual
  nodes (session affinity). The ring never mutates: draining a pod just
  makes the walk skip it, so ONLY the drained pod's keys move (to their
  ring successors) and they return home when it un-drains.
* ``prefix-hash``: same ring, but the key is the request's prefix FAMILY
  anchor. The declared prefix is chunked into the same chained block
  digests the radix registry (``PrefixRadix``) uses; the router keeps a
  digest -> anchor map and routes on the deepest already-seen ancestor,
  so "system prompt" and "system prompt + few-shot variant k" all hash
  to one pod and share ancestor pages there instead of scattering
  per-variant. Falls back to the legacy whole-prefix digest
  (``GenRequest.prefix_digest``), then to the rid hash. Draining behaves
  like consistent-hash: a drained pod's anchors move to the ring
  successor, whose registry re-materializes the family on first miss,
  and they return home on undrain.

Both policies spill before they reject: if no engine in the preferred pod
can EVER fit a request (slab / page-table span / pool / frontend
mismatch), the router walks the remaining preference order and re-routes
-- draining pods included, as a last resort, so a request feasible only
on a pod that is transiently draining waits for it instead of dying. A
request is rejected only when EVERY pod agrees it is infeasible, with the
reasons aggregated across the fleet.

Draining a pod at the router (``drain_pod``) is the fleet-deployer hook:
new traffic routes around it, its queued + in-flight work finishes, and
fleet ``capacity`` drops by exactly that pod -- never below N-1 pods
during a rolling upgrade.

Router state persists next to pod state (``<root>/pods/<router_id>.json``,
``"kind": "router"``) so ``repro ps`` reads a fleet as one unit.

PyTorch port of ``repro.orchestrator.router``, line for line: the same
ring (``_hash64``), placement and ledger, over the port's pods.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import uuid
from pathlib import Path
from typing import Iterable

from repro_torch.orchestrator.obs.metrics import (MetricsRegistry,
                                                  merge_snapshots)
from repro_torch.orchestrator.obs.tracing import TraceBuffer
from repro_torch.orchestrator.pod import Pod
from repro_torch.orchestrator.prefix_registry import block_digests
from repro_torch.orchestrator.request_queue import GenRequest
from repro_torch.orchestrator.scheduler import ContinuousScheduler

PLACEMENT_POLICIES = ("shortest-queue", "consistent-hash", "prefix-hash")


def _hash64(key: str) -> int:
    # md5, not hash(): placement must be stable across processes (PYTHONHASHSEED)
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class PodRouter:
    STATE_EVERY = 8     # min ticks between router-state file refreshes

    def __init__(self, pods: Iterable[Pod], *,
                 policy: str = "shortest-queue", fairness_cap: int = 4,
                 vnodes: int = 64, shed_queue_depth: int | None = None,
                 shed_ttft_p99: int | None = None):
        self.pods: list[Pod] = list(pods)
        if not self.pods:
            raise ValueError("a PodRouter needs at least one pod")
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown placement policy {policy!r}; "
                f"choose from {PLACEMENT_POLICIES}")
        self.policy = policy
        self.router_id = f"router-{uuid.uuid4().hex[:8]}"
        self.runtime = self.pods[0].runtime
        # one scheduler+queue per pod: admission stays FIFO *within* a pod
        # (a pod's admission order is a subsequence of router submission
        # order), and pods tick independently -- the cross-host layout
        self.schedulers: list[ContinuousScheduler] = [
            ContinuousScheduler(p, fairness_cap=fairness_cap)
            for p in self.pods]
        self._sched = {p.pod_id: s
                       for p, s in zip(self.pods, self.schedulers)}
        # static hash ring: vnodes points per pod so key movement on drain
        # is ~1/N even with few pods
        ring = [(_hash64(f"{p.pod_id}#{v}"), p)
                for p in self.pods for v in range(vnodes)]
        self._ring = sorted(ring, key=lambda t: t[0])
        self._ring_keys = [h for h, _ in self._ring]
        self._draining: set[str] = set()
        self.tick = 0
        self._state_tick = -self.STATE_EVERY
        self.completed: list[GenRequest] = []
        self.rejected: list[GenRequest] = []    # router-level (no pod fits)
        self.shedded: list[GenRequest] = []     # QoS overload sheds
        # SLO shedding policy, driven by the LIVE registry: a pod is
        # overloaded when its queue_depth gauge or its merged ttft_ticks
        # p99 crosses the threshold. Batch submissions that only have
        # overloaded pods to land on are shed with a typed rejection
        # instead of enqueued to stall; interactive traffic is never shed
        # here. None disables that dimension (default: no shedding).
        self.shed_queue_depth = shed_queue_depth
        self.shed_ttft_p99 = shed_ttft_p99
        # router-tier observability: placement counters labelled by policy
        # (status renders them as "by_policy"), plus a span buffer for
        # route/reject events. ``requests_rejected`` mirrors the pod-level
        # counter name so the fleet rollup and the span-log recompute agree
        # on one total.
        self.metrics = MetricsRegistry()
        self.trace = TraceBuffer(name=self.router_id)
        self._c_routed = self.metrics.counter("routed", policy=policy)
        self._c_spilled = self.metrics.counter("spillover", policy=policy)
        self._c_rejected = self.metrics.counter("rejected", policy=policy)
        self._c_req_rejected = self.metrics.counter("requests_rejected")
        self._c_shed = self.metrics.counter("shed", policy=policy)
        self._c_req_shed = self.metrics.counter("requests_shed")
        # prefix-hash family anchors: chained block digest -> the digest
        # the whole FAMILY routes on. The radix registry shares ancestor
        # pages across prefix variants, so per-variant digests must not
        # scatter a family across pods -- every chain member maps to the
        # anchor of the first family it overlaps (deepest registered
        # ancestor at first sight). Grows with distinct prefix blocks seen;
        # host-side bookkeeping only.
        self._family_anchor: dict[str, str] = {}
        self._page_size = next(
            (e.page_size for p in self.pods for e in p.engines
             if getattr(e, "paged", False)), None)
        # incremental outstanding-work ledger (tokens committed, not yet
        # finished) so shortest-queue placement is O(P log P) per request
        # instead of rescanning every queue and slot bank
        self._outstanding = {p.pod_id: 0 for p in self.pods}
        self._rejected_seen = [0] * len(self.schedulers)
        self._shedded_seen = [0] * len(self.schedulers)
        for p in self.pods:
            p.router = self.router_id
            p.write_state()
        self.write_state()

    # registry-backed shims for the pre-registry attribute names
    @property
    def routed(self) -> int:
        return self._c_routed.value

    @property
    def spilled(self) -> int:
        return self._c_spilled.value

    def trace_buffers(self) -> list[TraceBuffer]:
        """Every span buffer in the fleet (router first, then pods) --
        what ``export_chrome`` and the report decomposition consume."""
        return [self.trace] + [p.trace for p in self.pods]

    # -- placement -----------------------------------------------------------
    def is_draining(self, pod: Pod) -> bool:
        return pod.pod_id in self._draining

    def load(self, pod: Pod) -> int:
        """Shortest-queue metric: outstanding decode WORK committed to the
        pod, in tokens (budgets routed there and not yet finished). A plain
        request count is blind to budgets (a trace whose long requests
        correlate with submit order then piles every long request onto one
        pod); weighting by tokens keeps the backlog balanced. Maintained
        incrementally -- credited at routing, debited at completion/
        rejection -- so placement never rescans queues or slot banks."""
        return self._outstanding[pod.pod_id]

    def scheduler_for(self, pod: Pod) -> ContinuousScheduler:
        return self._sched[pod.pod_id]

    def _prefix_key(self, req: GenRequest) -> str:
        """Ring key for prefix-hash placement: the DEEPEST already-seen
        ancestor's family anchor. A request's declared prefix is chunked
        into chained block digests (the same addressing the radix registry
        uses); if any of them was seen before, the request adopts that
        family's anchor -- so "system prompt" and "system prompt +
        few-shot" land on the same pod and the radix can share the
        ancestor pages. A brand-new family anchors on its own deepest
        digest. Requests with no usable prefix fall back to the legacy
        whole-prefix digest, then to rid session affinity."""
        chain: list[str] = []
        if self._page_size is not None and req.prefix_len \
                and req.frontend is None:
            cap = min(req.prefix_len, req.prompt_len - 1)
            if cap >= 1:
                chain = block_digests(req.prompt[:cap], self._page_size)
        if not chain:
            return (f"px:{req.prefix_digest}" if req.prefix_digest
                    else f"rid:{req.rid}")
        anchor = None
        for d in reversed(chain):
            a = self._family_anchor.get(d)
            if a is not None:
                anchor = a
                break
        if anchor is None:
            anchor = chain[-1]
        for d in chain:
            self._family_anchor.setdefault(d, anchor)
        return f"px:{anchor}"

    def _candidates(self, req: GenRequest) -> list[Pod]:
        """Every pod in placement-preference order for ``req``: live pods
        by policy first, draining pods as a LAST resort -- a request
        feasible only on a pod that is transiently draining (a rolling
        upgrade) waits in its queue rather than being terminally rejected.
        The first entry is the policy's choice; the rest spill over."""
        if self.policy in ("consistent-hash", "prefix-hash"):
            # prefix-hash: place on the request's FAMILY ANCHOR digest so
            # every prefix variant sharing any radix ancestor walks to the
            # pod whose pool holds those chain pages; digest-less requests
            # degrade to plain rid session affinity
            key = (self._prefix_key(req) if self.policy == "prefix-hash"
                   else f"rid:{req.rid}")
            i = bisect.bisect_right(self._ring_keys, _hash64(key))
            order, seen = [], set()
            for k in range(len(self._ring)):
                p = self._ring[(i + k) % len(self._ring)][1]
                if p.pod_id not in seen:
                    seen.add(p.pod_id)
                    order.append(p)
                    if len(order) == len(self.pods):
                        break
        else:
            order = sorted(self.pods, key=lambda p: (self.load(p),
                                                     self.pods.index(p)))
        return ([p for p in order if p.pod_id not in self._draining]
                + [p for p in order if p.pod_id in self._draining])

    def _first_fit(self, req: GenRequest, order: list[Pod]) -> Pod | None:
        return next(
            (p for p in order if any(e.fits(req) for e in p.engines)), None)

    def overloaded(self, pod: Pod) -> bool:
        """The shedding policy's overload read, straight off the pod's
        live registry: the ``queue_depth`` gauge (set by its scheduler on
        every submit and tick) or the merged ``ttft_ticks`` p99 over the
        configured threshold. False when no threshold is set."""
        if (self.shed_queue_depth is not None
                and pod.metrics.gauge("queue_depth").value
                >= self.shed_queue_depth):
            return True
        if self.shed_ttft_p99 is not None:
            h = pod.metrics.merged_histogram("ttft_ticks")
            if h is not None and h.count \
                    and h.percentile(99) >= self.shed_ttft_p99:
                return True
        return False

    def _shed(self, req: GenRequest) -> None:
        """Typed shed rejection at the router tier: every pod that could
        fit this batch request is over the overload threshold."""
        req.state, req.finish_reason = "shed", "shed"
        req.error = ("shed: fleet overloaded (queue_depth >= "
                     f"{self.shed_queue_depth}, ttft p99 >= "
                     f"{self.shed_ttft_p99})")
        req.done_tick = self.tick
        self.shedded.append(req)
        self._c_shed.inc()
        self._c_req_shed.inc()
        self.trace.record(req.rid, "shed", self.tick, reason="overload",
                          priority=req.priority, policy=self.policy)

    def place(self, req: GenRequest) -> Pod | None:
        """The pod ``req`` would route to right now (spillover applied);
        None if no pod can ever fit it. Pure query -- no submission."""
        return self._first_fit(req, self._candidates(req))

    def submit(self, reqs: Iterable[GenRequest] | GenRequest) -> None:
        if isinstance(reqs, GenRequest):
            reqs = [reqs]
        refresh_before = len(self.rejected) + len(self.shedded)
        shedding = (self.shed_queue_depth is not None
                    or self.shed_ttft_p99 is not None)
        for req in reqs:
            order = self._candidates(req)
            chosen = self._first_fit(req, order)
            if (chosen is not None and shedding
                    and req.priority == "batch"):
                # overload-spill before shed: a batch request prefers the
                # policy's pod but takes any fitting non-overloaded pod
                # over stalling; only when EVERY fitting pod is over the
                # threshold is it shed. Interactive traffic bypasses this
                # entirely -- the lanes + preemption downstream protect it.
                under = next(
                    (p for p in order
                     if any(e.fits(req) for e in p.engines)
                     and not self.overloaded(p)), None)
                if under is None:
                    self._shed(req)
                    continue
                chosen = under
            if chosen is None:
                # EVERY pod agrees (draining ones included): infeasible
                # fleet-wide. Reject at the router -- never enqueue a
                # request that can only stall -- with the per-engine
                # reasons aggregated across pods.
                req.state, req.finish_reason = "rejected", "oversized"
                reasons = sorted({e.reject_reason(req)
                                  for p in order for e in p.engines})
                req.error = ("; ".join(reasons) if reasons
                             else "router has no pods")
                req.done_tick = self.tick
                self.rejected.append(req)
                self._c_rejected.inc()
                self._c_req_rejected.inc()
                self.trace.record(req.rid, "reject", self.tick,
                                  reason="infeasible", policy=self.policy)
                continue
            req.spilled = chosen is not order[0]
            if req.spilled:
                self._c_spilled.inc()
            req.pod = chosen.pod_id
            self._c_routed.inc()
            # router-tier spans live in the ROUTER's buffer: recording the
            # route into the chosen pod's buffer meant a dying pod took the
            # placement record down with it and fleet-wide span closure
            # could no longer prove the request was ever routed
            self.trace.record(req.rid, "route", self.tick,
                              pod=chosen.pod_id, policy=self.policy,
                              spilled=req.spilled)
            self._outstanding[chosen.pod_id] += req.max_new_tokens
            self._sched[chosen.pod_id].submit(req)
        if len(self.rejected) + len(self.shedded) != refresh_before:
            # router-level rejections and sheds happen BETWEEN ticks
            # (submit time), so the step() throttle would never see them:
            # one refresh per rejecting submit batch keeps `repro ps` honest
            self.write_state()

    # -- drain control (the fleet-deployer hook) -----------------------------
    def drain_pod(self, pod: Pod) -> None:
        """Route new traffic around ``pod``. Already-queued and in-flight
        requests on it still run to completion via its own scheduler."""
        self._draining.add(pod.pod_id)
        self.write_state()

    def undrain_pod(self, pod: Pod) -> None:
        self._draining.discard(pod.pod_id)
        self.write_state()

    # -- the global tick -----------------------------------------------------
    def step(self) -> list[GenRequest]:
        """One fleet tick: every pod's scheduler advances once. Pods are
        independent hosts -- a tick is the lockstep abstraction of them
        decoding concurrently, so fleet throughput is tokens per ROUTER
        tick (what fig8 measures)."""
        done: list[GenRequest] = []
        rejected = admitted = 0
        for i, s in enumerate(self.schedulers):
            adm0 = s.queue.admitted
            done.extend(s.step())
            admitted += s.queue.admitted - adm0
            # debit post-placement scheduler rejections from the ledger
            # (rare: geometry changed under a routed request, e.g. upgrade)
            for req in s.rejected[self._rejected_seen[i]:]:
                if req.pod in self._outstanding:
                    self._outstanding[req.pod] -= req.max_new_tokens
                rejected += 1
            self._rejected_seen[i] = len(s.rejected)
            # deadline sheds terminate a routed request at the SCHEDULER
            # tier just like rejections do -- without this debit a shed
            # burst permanently over-counts the pod and shortest-queue
            # placement routes around it forever
            for req in s.shedded[self._shedded_seen[i]:]:
                if req.pod in self._outstanding:
                    self._outstanding[req.pod] -= req.max_new_tokens
                rejected += 1
            self._shedded_seen[i] = len(s.shedded)
        for req in done:
            # guard: a request submitted to a member scheduler directly
            # (bypassing the router) was never credited to the ledger
            if req.pod in self._outstanding:
                self._outstanding[req.pod] -= req.max_new_tokens
        self.completed.extend(done)
        self.tick += 1
        # same refresh rule the pod scheduler follows (admissions count:
        # a saturated fleet must not read as idle in `repro ps`)
        if (done or admitted or rejected) and (
                self.tick - self._state_tick >= self.STATE_EVERY):
            self.write_state()
            self._state_tick = self.tick
        return done

    @property
    def busy(self) -> bool:
        return any(s.busy for s in self.schedulers)

    def run(self, max_ticks: int | None = None) -> list[GenRequest]:
        start = self.tick
        while self.busy:
            if max_ticks is not None and self.tick - start >= max_ticks:
                break
            self.step()
        # final snapshots for the router AND every member pod: step() calls
        # the schedulers' step directly, so nothing else flushes a pod's
        # state after its last throttled write
        self.write_state()
        for p in self.pods:
            p.write_state()
        return self.completed

    # -- fleet accounting ----------------------------------------------------
    @property
    def capacity(self) -> int:
        """Admissible slots fleet-wide; drained pods contribute nothing
        (the N-1 invariant the deployer tests pin)."""
        return sum(p.capacity for p in self.pods
                   if p.pod_id not in self._draining)

    @property
    def free_slots(self) -> int:
        return sum(p.free_slots for p in self.pods
                   if p.pod_id not in self._draining)

    @property
    def pending(self) -> int:
        return sum(s.queue.pending for s in self.schedulers)

    @property
    def rejected_total(self) -> int:
        """Router-level (no pod fits at placement) + per-pod scheduler
        rejections (post-placement geometry changes, e.g. an upgrade)."""
        return (len(self.rejected)
                + sum(len(s.rejected) for s in self.schedulers))

    @property
    def shed_total(self) -> int:
        """Router-tier overload sheds + per-pod admission-deadline sheds."""
        return (len(self.shedded)
                + sum(len(s.shedded) for s in self.schedulers))

    def status(self) -> dict:
        return {
            "kind": "router",
            "router": self.router_id,
            "policy": self.policy,
            "pods": [p.pod_id for p in self.pods],
            "draining": sorted(self._draining),
            "capacity": self.capacity,
            "free_slots": self.free_slots,
            "pending": self.pending,
            "routed": self.routed,
            "spilled": self.spilled,
            "completed": len(self.completed),
            "rejected": self.rejected_total,
            "shed": self.shed_total,
            "shed_thresholds": {"queue_depth": self.shed_queue_depth,
                                "ttft_p99": self.shed_ttft_p99},
            "by_policy": {self.policy: {
                "routed": self._c_routed.value,
                "spillover": self._c_spilled.value,
                "rejected": self._c_rejected.value,
                "shed": self._c_shed.value,
            }},
            "metrics": merge_snapshots(
                [self.metrics.snapshot()]
                + [p.metrics.snapshot() for p in self.pods]),
            "trace": self.trace.status(),
            "pid": os.getpid(),
            "members": [{
                "pod": p.pod_id,
                "image": p.image.short_digest,
                "capacity": p.capacity,
                "free_slots": p.free_slots,
                "pending": self._sched[p.pod_id].queue.pending,
                "active": sum(len(e.active) for e in p.engines),
                "rejected": p.rejected,
                "shed": p.shed,
                "overloaded": self.overloaded(p),
                "draining": p.pod_id in self._draining,
            } for p in self.pods],
        }

    def write_state(self, final: bool = False) -> Path:
        """Same dir + atomic protocol as ``Pod.write_state`` so ``repro
        ps`` discovers routers and pods in one glob."""
        d = Path(self.runtime.root) / "pods"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{self.router_id}.json"
        status = self.status()
        status["phase"] = ("exited" if final
                          else "serving" if any(
                              e.active for pod in self.pods
                              for e in pod.engines)
                          else "idle")
        if final:
            for pod in self.pods:
                pod.write_state(final=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(status, indent=2))
        os.replace(tmp, p)
        return p
