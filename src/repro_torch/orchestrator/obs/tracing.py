"""Request lifecycle tracing: typed span events in a bounded ring buffer,
with a Chrome trace-event exporter.

Every ``GenRequest`` accrues point events as it moves through the stack::

    submit -> [route] -> queue -> admit|reject|shed -> prefill
           -> decode_chunk* -> [preempt -> resume -> ...]* -> complete

``shed`` is the QoS overload path (router threshold shedding or a missed
admission deadline); ``preempt``/``resume`` bracket a page-level
preemption (pages released mid-decode, suffix re-prefill later).

recorded into the owning pod's ``TraceBuffer`` (the router keeps its own
buffer for placement events and fleet-level rejections). Timestamps are
scheduler *ticks* -- the deterministic clock the whole orchestrator runs
on -- so the same trace replayed twice produces the byte-identical span
log, and aggregate metrics recomputed from it bitwise-match the live
registry (see ``obs.report.recompute_registry``).

``export_chrome`` pairs the point events into Chrome trace-event JSON
(``ph: "X"`` complete events on a per-request timeline), so a serve run
recorded with ``serve --trace out.json`` opens directly in Perfetto /
``chrome://tracing``: one process row per pod, one thread row per
request, with queue/prefill/decode spans carrying pod/replica/slot/
page-count/prefix-hit attributes in ``args``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass
from pathlib import Path

SPAN_KINDS = ("submit", "route", "queue", "admit", "reject", "shed",
              "prefill", "decode_chunk", "preempt", "resume", "complete",
              "spill", "restore", "heartbeat", "evict", "reroute")

# The lifecycle state machine as data: kind -> legal predecessors within
# one (buffer, rid) span log. ``None`` means the kind may start a log:
# ``route`` lands in the chosen pod's buffer before ``submit``, and the
# router's own buffer opens fleet-level ``reject``/``shed`` logs with no
# preceding submit. ``repro lint`` derives its span-lifecycle rule from
# this table (keep it a pure literal) and ``validate_span_log`` replays
# recorded buffers against it.
SPAN_TRANSITIONS = {
    "submit": (None, "route"),
    "route": (None,),
    "queue": ("submit",),
    "admit": ("submit", "queue"),
    # route/reroute predecessors: the ROUTER's buffer rejects a request
    # after recording its placement when no (surviving) member can ever
    # fit it -- the fleet-level infeasible path
    "reject": (None, "submit", "queue", "preempt", "route", "reroute"),
    "shed": (None, "submit", "queue", "preempt"),
    "prefill": ("admit", "resume", "spill", "restore"),
    "decode_chunk": ("prefill", "decode_chunk", "spill"),
    "preempt": ("prefill", "decode_chunk"),
    # a resume may START a log: a request rerouted off a dead pod arrives
    # at the survivor already preempted (the pod death was its implicit
    # preemption) and its resume is the first span in the survivor's buffer
    "resume": (None, "preempt"),
    "complete": ("prefill", "decode_chunk"),
    # spill-tier movements of the prefix registry, attributed to the
    # request whose allocation/share triggered them: spills fire under any
    # pool pressure (admission prefill or decode alloc-on-write -- the
    # latter lands after the request's own prefill/decode spans), restores
    # only while mapping a matched chain (between admit/resume and the
    # suffix prefill)
    "spill": ("admit", "resume", "prefill", "decode_chunk", "spill",
              "restore"),
    "restore": ("admit", "resume", "spill", "restore"),
    # fabric-tier spans, recorded in the ROUTER's buffer only. Heartbeats
    # accrue per member under a synthetic per-pod rid (-1 - ordinal);
    # evict closes that member's log. Reroute is recorded under the
    # REQUEST's rid after its route span -- a request rerouted twice
    # (cascading pod deaths) chains reroute -> reroute.
    "heartbeat": (None, "heartbeat"),
    "evict": (None, "heartbeat"),
    "reroute": ("route", "reroute"),
}

# kinds with no successors: once recorded, the (buffer, rid) log is closed
# (evict closes a fabric member's synthetic heartbeat log; replacement pods
# get a fresh ordinal, so an evicted member's rid never records again)
TERMINAL_SPANS = ("reject", "shed", "complete", "evict")

# one tick rendered as 1000 "microseconds" so sub-tick spans (prefill) stay
# visible at default Perfetto zoom
TICK_US = 1000


@dataclass(frozen=True)
class SpanEvent:
    """One typed point event in a request's lifecycle. ``attrs`` is a
    sorted (key, value) tuple -- hashable and deterministically ordered,
    so span logs compare byte-for-byte across runs.

    ``wall`` is an OPTIONAL wall-clock timestamp (``time.time()``) carried
    ALONGSIDE the tick for fabric runs where pods are real processes with
    real clocks. It is deliberately outside ``attrs`` and excluded from
    the determinism story: in-process runs record ``None`` everywhere so
    span logs still compare byte-for-byte, and the recompute/validate
    paths never read it."""
    rid: int
    name: str
    tick: int
    attrs: tuple = ()
    wall: float | None = None

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default


class TraceBuffer:
    """Bounded ring buffer of span events (one per pod, one per router).

    Fixed capacity: a long-lived serving fleet records forever and the
    oldest spans fall off; ``dropped`` counts them so exporters and the
    recompute check know whether the log is complete."""

    def __init__(self, capacity: int = 1 << 16, name: str = "trace"):
        if capacity < 1:
            raise ValueError("TraceBuffer needs capacity >= 1")
        self.capacity = int(capacity)
        self.name = name
        self._events: deque[SpanEvent] = deque(maxlen=self.capacity)
        self.recorded = 0

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._events)

    def record(self, rid: int, name: str, tick: int, *,
               wall: float | None = None, **attrs) -> None:
        if name not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {name!r}; one of {SPAN_KINDS}")
        self._events.append(SpanEvent(
            rid=int(rid), name=name, tick=int(tick),
            attrs=tuple(sorted(attrs.items())), wall=wall))
        self.recorded += 1

    def events(self) -> list[SpanEvent]:
        return list(self._events)

    def by_request(self) -> dict[int, list[SpanEvent]]:
        """Events grouped per rid, in record order (which is tick order:
        the scheduler records monotonically)."""
        out: dict[int, list[SpanEvent]] = {}
        for e in self._events:
            out.setdefault(e.rid, []).append(e)
        return out

    def clear(self) -> None:
        self._events.clear()
        self.recorded = 0

    def status(self) -> dict:
        return {"capacity": self.capacity, "buffered": len(self._events),
                "recorded": self.recorded, "dropped": self.dropped}


def validate_span_log(buffers) -> dict:
    """Replay recorded span buffers against ``SPAN_TRANSITIONS``: within
    each ``(buffer, rid)`` log every event's predecessor must be legal,
    nothing may follow a terminal span, and ticks must be monotone.
    Buffers that have dropped events (ring overflow) skip the
    start-of-log check -- the true first span may have fallen off.
    Raises ``ValueError`` at the first violation; returns summary stats.
    """
    n_buffers = 0
    requests = 0
    events = 0
    for buf in buffers:
        n_buffers += 1
        truncated = buf.dropped > 0
        for rid, evs in sorted(buf.by_request().items()):
            requests += 1
            prev = None
            for e in evs:
                events += 1
                allowed = SPAN_TRANSITIONS.get(e.name)
                if allowed is None:
                    raise ValueError(
                        f"{buf.name}/rid {rid}: unknown span kind "
                        f"{e.name!r}")
                if prev is None:
                    if None not in allowed and not truncated:
                        raise ValueError(
                            f"{buf.name}/rid {rid}: log starts with "
                            f"{e.name!r}, which requires a predecessor "
                            f"in {allowed}")
                else:
                    if prev.name in TERMINAL_SPANS:
                        raise ValueError(
                            f"{buf.name}/rid {rid}: {e.name!r} recorded "
                            f"after terminal span {prev.name!r}")
                    if prev.name not in allowed:
                        raise ValueError(
                            f"{buf.name}/rid {rid}: illegal transition "
                            f"{prev.name!r} -> {e.name!r} (legal "
                            f"predecessors: {allowed})")
                    if e.tick < prev.tick:
                        raise ValueError(
                            f"{buf.name}/rid {rid}: tick goes backwards "
                            f"at {e.name!r} ({prev.tick} -> {e.tick})")
                prev = e
    return {"buffers": n_buffers, "requests": requests,
            "events": events}


def dump_span_log(buffer: TraceBuffer, path: str | Path) -> Path:
    """Persist one buffer's span log as JSON -- the per-process span file a
    fabric worker flushes so the router-side closure check (and ``repro
    lint``'s cross-process pooling) can read spans emitted in another
    process. ``recorded`` rides along so ``dropped`` survives the round
    trip and truncated logs keep skipping the start-of-log check."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"name": buffer.name, "capacity": buffer.capacity,
           "recorded": buffer.recorded,
           "events": [[e.rid, e.name, e.tick, list(e.attrs), e.wall]
                      for e in buffer.events()]}
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(doc))
    os.replace(tmp, path)
    return path


def load_span_log(path: str | Path) -> TraceBuffer:
    """Rehydrate a ``dump_span_log`` file into a TraceBuffer equivalent to
    the one that wrote it (same name/capacity/recorded), so every
    validator and exporter consumes local and cross-process spans through
    one type."""
    doc = json.loads(Path(path).read_text())
    buf = TraceBuffer(capacity=doc["capacity"], name=doc["name"])
    for rid, name, tick, attrs, wall in doc["events"]:
        buf._events.append(SpanEvent(
            rid=int(rid), name=name, tick=int(tick),
            attrs=tuple((k, v) for k, v in attrs), wall=wall))
    buf.recorded = int(doc["recorded"])
    return buf


def validate_fleet_closure(buffers) -> dict:
    """Cross-buffer lifecycle closure: every ROUTED request must reach a
    terminal span SOMEWHERE in the fleet, even though its lifecycle is
    split across buffers (route/reroute in the router's, submit..complete
    in one or more pods' -- more than one when a pod died mid-decode and
    the request resumed on a survivor).

    This is the zero-lost-requests check the fault-injection benchmark
    gates on: a request routed to a pod that was killed and never
    rerouted shows up here as an open lifecycle. Synthetic fabric rids
    (negative: per-member heartbeat/evict logs) are exempt -- they close
    per-buffer via ``evict`` and never represent user work. Buffers that
    dropped events skip the check (the terminal may have fallen off the
    ring). Raises ``ValueError`` naming the first open request; returns
    summary stats."""
    routed: dict[int, int] = {}      # rid -> reroute count
    closed: set[int] = set()
    truncated = False
    for buf in buffers:
        truncated = truncated or buf.dropped > 0
        for e in buf.events():
            if e.rid < 0:
                continue
            if e.name == "route":
                routed.setdefault(e.rid, 0)
            elif e.name == "reroute":
                routed[e.rid] = routed.get(e.rid, 0) + 1
            elif e.name in TERMINAL_SPANS:
                closed.add(e.rid)
    open_rids = sorted(set(routed) - closed)
    if open_rids and not truncated:
        raise ValueError(
            f"fleet span closure: {len(open_rids)} routed request(s) never "
            f"reached a terminal span (first: rid {open_rids[0]}) -- "
            "work was lost")
    return {"routed": len(routed), "closed": len(set(routed) & closed),
            "rerouted": sum(1 for n in routed.values() if n),
            "reroutes": sum(routed.values()), "truncated": truncated}


def _x(name, ts, dur, pid, tid, rid, **args):
    return {"name": name, "ph": "X", "ts": ts * TICK_US,
            "dur": max(0, dur) * TICK_US, "pid": pid, "tid": tid,
            "args": {"rid": rid, **args}}


def _i(name, ts, pid, tid, rid, **args):
    return {"name": name, "ph": "i", "s": "t", "ts": ts * TICK_US,
            "pid": pid, "tid": tid, "args": {"rid": rid, **args}}


def export_chrome(buffers, path: str | Path | None = None) -> dict:
    """Render span buffers as a Chrome trace-event JSON object (and write
    it to ``path`` when given). One pid per buffer (pod / router), one tid
    per request; point events are paired into ``X`` complete spans:

    * ``queue``   : submit (or arrival, whichever is later) -> admit/reject
    * ``prefill`` : the admission (or resume) tick (1 tick wide), with
      positions/pages/prefix-hit attrs
    * ``decode``  : one span per decode chunk, ``chunk`` ticks wide
    * ``paused``  : preempt -> resume (pages released, request queued)
    * ``generate``: admit -> complete envelope (tokens attr)
    * ``route`` / ``reject`` / ``shed`` / ``preempt`` / ``resume`` /
      ``complete`` / ``spill`` / ``restore``: instants (the last two are
      the prefix registry's tier movements, digest attr)
    """
    events = []
    for pid, buf in enumerate(buffers):
        events.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                       "args": {"name": getattr(buf, "name", f"pod{pid}")}})
        for rid, evs in sorted(buf.by_request().items()):
            tid = rid
            submit = admit = None
            baseline = None
            preempt = None
            for e in evs:
                if e.name == "submit":
                    submit = e
                    baseline = max(e.tick, int(e.attr("arrival", e.tick)))
                elif e.name == "route":
                    events.append(_i("route", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "admit":
                    admit = e
                    if baseline is not None:
                        events.append(_x("queue", baseline,
                                         e.tick - baseline, pid, tid, rid))
                elif e.name == "preempt":
                    preempt = e
                    events.append(_i("preempt", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "resume":
                    if preempt is not None:
                        events.append(_x("paused", preempt.tick,
                                         e.tick - preempt.tick, pid, tid,
                                         rid))
                        preempt = None
                    events.append(_i("resume", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "shed":
                    if baseline is not None:
                        events.append(_x("queue", baseline,
                                         e.tick - baseline, pid, tid, rid))
                    events.append(_i("shed", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "prefill":
                    events.append(_x("prefill", e.tick, 1, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "decode_chunk":
                    events.append(_x("decode", e.tick,
                                     int(e.attr("chunk", 1)), pid, tid, rid,
                                     slot=e.attr("slot")))
                elif e.name == "spill":
                    events.append(_i("spill", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "restore":
                    events.append(_i("restore", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "heartbeat":
                    events.append(_i("heartbeat", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "evict":
                    events.append(_i("evict", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "reroute":
                    events.append(_i("reroute", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "reject":
                    if baseline is not None:
                        events.append(_x("queue", baseline,
                                         e.tick - baseline, pid, tid, rid))
                    events.append(_i("reject", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
                elif e.name == "complete":
                    if admit is not None:
                        events.append(_x("generate", admit.tick,
                                         e.tick - admit.tick, pid, tid, rid,
                                         tokens=e.attr("tokens")))
                    events.append(_i("complete", e.tick, pid, tid, rid,
                                     **dict(e.attrs)))
    # deterministic, per-request-monotone order: spans are paired out of
    # record order (the generate envelope starts at admit but is only
    # known at complete), so sort non-metadata events by (pid, rid, ts)
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["pid"], e["args"]["rid"], e["ts"]))
    trace = {"traceEvents": meta + rest, "displayTimeUnit": "ms",
             "otherData": {"clock": "scheduler ticks",
                           "tick_us": TICK_US}}
    if path is not None:
        Path(path).write_text(json.dumps(trace, indent=1))
    return trace


def validate_chrome_trace(trace: dict | str | Path) -> dict:
    """Minimal schema check for an exported trace (the CI gate): a
    non-empty ``traceEvents`` list, every event carrying ``ph``/``ts``/
    ``pid``/``name``, complete (``ph:"X"``) events carrying a present and
    non-negative ``dur``, and timestamps monotone per request (grouped by
    ``(pid, args.rid)``). Raises ``ValueError`` with the first violation;
    returns summary stats on success."""
    if not isinstance(trace, dict):
        trace = json.loads(Path(trace).read_text())
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents")
    last_ts: dict[tuple, float] = {}
    requests = set()
    for i, e in enumerate(events):
        for key in ("name", "ph", "ts", "pid"):
            if key not in e:
                raise ValueError(f"event {i} ({e}) is missing {key!r}")
        if e["ph"] == "M":
            continue
        if e["ph"] == "X":
            # a complete event without ANY dur is malformed, not 0-length:
            # defaulting it used to let dur-less spans slide through CI
            if "dur" not in e:
                raise ValueError(f"event {i} ({e['name']}) is a complete "
                                 "event with no 'dur'")
            if e["dur"] < 0:
                raise ValueError(f"event {i} has negative duration")
        rid = (e.get("args") or {}).get("rid")
        if rid is None:
            raise ValueError(f"event {i} carries no args.rid")
        key = (e["pid"], rid)
        requests.add(key)
        if e["ts"] < last_ts.get(key, 0):
            raise ValueError(
                f"event {i} ({e['name']}) goes backwards for request {key}: "
                f"ts {e['ts']} < {last_ts[key]}")
        last_ts[key] = e["ts"]
    return {"events": len(events), "requests": len(requests)}
