"""Derived latency decomposition from span logs: TTFT, ITL, and the
registry-recompute check.

Definitions (tick clock, measured from request ARRIVAL -- the trace
stagger is offered load, not queueing delay, same convention as
``telemetry.request_latencies``):

* **TTFT** (time-to-first-token): ticks from ``max(arrival, submit)`` to
  the admission tick. The first token is sampled by the prefill dispatch
  on the admission tick itself, so TTFT == queueing delay + prefill.
* **ITL** (inter-token latency): decode ticks per generated token after
  the first, ``(done - admit) / (n_tokens - 1)``. Stored in the registry
  as integer *milli-ticks* (floor) so the histogram stays exact and
  deterministic; reported in ticks.

``recompute_registry`` rebuilds the pod-level completion metrics purely
from a span log. Because both sides run the same integer formulas on the
same tick stamps, a complete log (``dropped == 0``) recomputes to the
bitwise-identical snapshot the live registry wrote -- the determinism
check the acceptance criteria pin (same trace -> same numbers).
"""

from __future__ import annotations

from repro_torch.orchestrator.obs.metrics import MetricsRegistry
from repro_torch.orchestrator.telemetry import nearest_rank

# one geometry for every tick-valued histogram (latency/ttft) and for the
# milli-tick ITL histogram -- shared by the live scheduler and the
# recompute path so their snapshots are comparable field-for-field
TICK_HIST = dict(width=1, n_buckets=4096)
ITL_HIST = dict(width=50, n_buckets=1024)       # 0.05-tick resolution


def itl_milliticks(admit_tick: int, done_tick: int, n_tokens: int) -> int:
    """Integer milli-ticks per post-first token; 0 for single-token
    requests (no inter-token gap exists)."""
    if n_tokens <= 1:
        return 0
    return ((done_tick - admit_tick) * 1000) // (n_tokens - 1)


def observe_completion(metrics: MetricsRegistry, *, arrival: int,
                       submit_tick: int, admit_tick: int, done_tick: int,
                       n_tokens: int, rid: int | None = None) -> None:
    """Record one completed request into a pod registry. The ONLY writer
    of the completion metrics -- the live scheduler and the span-log
    recompute both call this, so they agree by construction. ``rid``
    tags each latency bucket with a representative request (exemplar), so
    a p99 read links back to a concrete trace; exemplars min-combine, so
    passing rids in any order keeps the bitwise match."""
    base = max(arrival, submit_tick)
    metrics.counter("requests_completed").inc()
    metrics.counter("tokens_out").inc(n_tokens)
    metrics.histogram("latency_ticks", **TICK_HIST).record(
        done_tick - base, exemplar=rid)
    metrics.histogram("ttft_ticks", **TICK_HIST).record(
        admit_tick - base, exemplar=rid)
    metrics.histogram("itl_milliticks", **ITL_HIST).record(
        itl_milliticks(admit_tick, done_tick, n_tokens), exemplar=rid)


def request_lifecycles(buffers) -> dict[int, dict]:
    """Per-request lifecycle digest from span buffers: rid -> {submit,
    arrival, admit, done, tokens, chunks, rejected, shed, preemptions}.
    Buffers are merged (router + pods), so route/reject/shed events
    recorded at the router tier land on the same rid as the pod-side
    spans. ``admit`` is the FIRST admission tick (the TTFT anchor) -- a
    preempted request's resume never moves it."""
    out: dict[int, dict] = {}
    for buf in buffers:
        for e in buf.events():
            rec = out.setdefault(e.rid, {
                "submit": None, "arrival": 0, "admit": None, "done": None,
                "tokens": 0, "chunks": 0, "rejected": False, "shed": False,
                "preemptions": 0, "priority": None})
            if e.name == "submit":
                rec["submit"] = e.tick
                rec["arrival"] = int(e.attr("arrival", 0))
            elif e.name == "admit":
                if rec["admit"] is None:
                    rec["admit"] = e.tick
                if e.attr("priority") is not None:
                    rec["priority"] = e.attr("priority")
            elif e.name == "decode_chunk":
                rec["chunks"] += 1
            elif e.name == "preempt":
                rec["preemptions"] += 1
            elif e.name == "reject":
                rec["rejected"] = True
                rec["done"] = e.tick
            elif e.name == "shed":
                rec["shed"] = True
                rec["done"] = e.tick
            elif e.name == "complete":
                rec["done"] = e.tick
                rec["tokens"] = int(e.attr("tokens", 0))
    return out


def decomposition(buffers, priority: str | None = None) -> dict:
    """TTFT / ITL percentiles across all COMPLETED requests in the span
    buffers, using the repo-wide nearest-rank definition on the exact
    per-request values. ``latency_count`` 0 means "no samples" -- render
    ``-``, not 0 (the empty-input convention telemetry carries).

    Single-token completions have NO inter-token gap, so they are excluded
    from the ITL percentile list (``itl_count`` is the ITL sample count):
    counting their ``itl_milliticks == 0`` dragged reported ITL p50 toward
    0 on prefill-heavy traces. The registry histograms keep recording the
    0 samples -- the live-vs-recompute bitwise match is untouched.

    ``priority`` filters to one QoS class (requests tagged via the admit
    span's ``priority`` attr); None aggregates everything -- how fig10
    separates interactive and batch percentiles from one overload trace.
    """
    ttfts, itls = [], []
    for rec in request_lifecycles(buffers).values():
        if rec["rejected"] or rec["shed"] or rec["admit"] is None \
                or rec["done"] is None:
            continue
        if priority is not None and rec.get("priority") != priority:
            continue
        base = max(rec["arrival"], rec["submit"] if rec["submit"] is not None
                   else rec["admit"])
        ttfts.append(rec["admit"] - base)
        if rec["tokens"] >= 2:
            itls.append(itl_milliticks(rec["admit"], rec["done"],
                                       rec["tokens"]) / 1000.0)
    return {
        "latency_count": len(ttfts),
        "itl_count": len(itls),
        "ttft_p50_ticks": nearest_rank(ttfts, 50),
        "ttft_p99_ticks": nearest_rank(ttfts, 99),
        "itl_p50_ticks": nearest_rank(itls, 50),
        "itl_p99_ticks": nearest_rank(itls, 99),
    }


def recompute_registry(buffers) -> MetricsRegistry:
    """Rebuild the pod-level completion metrics from a span log alone.

    For a complete log (no ring-buffer drops) the returned registry's
    ``requests_completed`` / ``requests_rejected`` / ``tokens_out``
    counters and ``latency_ticks`` / ``ttft_ticks`` / ``itl_milliticks``
    histograms snapshot bitwise-identically to what the live schedulers
    recorded -- the tick clock makes observability replayable."""
    reg = MetricsRegistry()
    reg.counter("requests_rejected")
    reg.counter("requests_completed")
    reg.counter("requests_shed")
    reg.counter("tokens_out")
    reg.histogram("latency_ticks", **TICK_HIST)
    reg.histogram("ttft_ticks", **TICK_HIST)
    reg.histogram("itl_milliticks", **ITL_HIST)
    for rid, rec in sorted(request_lifecycles(buffers).items()):
        if rec["rejected"]:
            reg.counter("requests_rejected").inc()
            continue
        if rec["shed"]:
            reg.counter("requests_shed").inc()
            continue
        if rec["admit"] is None or rec["done"] is None:
            continue                    # still in flight at snapshot time
        observe_completion(
            reg, arrival=rec["arrival"],
            submit_tick=rec["submit"] if rec["submit"] is not None
            else rec["admit"],
            admit_tick=rec["admit"], done_tick=rec["done"],
            n_tokens=rec["tokens"], rid=rid)
    return reg


COMPLETION_METRICS = ("requests_completed", "requests_rejected",
                      "requests_shed", "tokens_out")
COMPLETION_HISTOGRAMS = ("latency_ticks", "ttft_ticks", "itl_milliticks")


def completion_snapshot(snap: dict) -> dict:
    """The comparable slice of a registry snapshot: completion counters +
    latency histograms, labels merged away (the recompute side has no
    replica labels)."""
    return {
        "counters": {name: sum(snap.get("counters", {}).get(name, {})
                               .values())
                     for name in COMPLETION_METRICS},
        "histograms": {name: snap.get("histograms", {}).get(name, {})
                       for name in COMPLETION_HISTOGRAMS},
    }
