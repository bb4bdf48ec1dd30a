"""Cross-host serving fabric: a message transport between router and pods.

``PodRouter`` ticks N in-process pods through direct method calls -- fine
for one host, but nothing about a real multi-host deployment (request
serialization, dead hosts, membership churn, elastic capacity) is
exercised. This module makes the router speak to pods over a framed
message protocol instead:

* **Codec** -- ``encode_request``/``decode_request`` serialize a
  ``GenRequest`` (prompt as base64 int32, frontend embeddings as base64
  float32, plus the resume state: generated tokens, admit tick,
  preemption count) and ``encode_frame``/``decode_frame`` wrap messages
  as ``\\x1e`` + JSON + newline, so a byte stream with interleaved stray
  output (library prints on a worker's stdout) still parses.
* **PodWorker** -- the pod side: one ``Pod`` + ``ContinuousScheduler``
  behind a ``handle(msg) -> reply`` dispatch (submit / step / hb /
  retire). Stateless about its peers: everything it knows arrives in
  messages, so the same worker runs in-process or as a subprocess.
  Terminal results are delivered at-least-once: a final payload rides
  every reply until the router acks its rid on a later step, so a reply
  lost to a flapping link never loses a completion (the router applies
  each rid once, duplicates are no-ops).
* **LoopbackTransport** -- in-memory, synchronous, deterministic: frames
  are encoded and decoded exactly as on a pipe (the codec is always
  exercised) but delivery is immediate. The unit-test and parity
  harness; also supports fault injection (``kill`` simulates SIGKILL,
  ``muted`` drops replies to simulate a flapping link).
* **ProcTransport** -- process-per-pod over stdin/stdout pipes: the
  headline harness. A reader thread pumps frames into a queue; EOF or a
  broken pipe marks the transport dead, so a kill -9'd worker is
  detected without waiting out a timeout.
* **FabricRouter** -- the router side: consistent-hash / shortest-queue
  placement over REMOTE capability descriptors, heartbeats with
  dead-pod eviction from the ring, exactly-once re-routing of a dead
  pod's in-flight work to survivors (requests with committed tokens
  resume via the preemption machinery's suffix re-prefill -- greedy
  decode makes the continuation bitwise-token-identical), and an
  elastic fleet: spawn pods when the outstanding-token backlog per pod
  crosses a threshold, drain + retire them when the fleet idles.

What stays lockstep-tick vs. wall-clock: *scheduling* is tick-clocked
everywhere -- the router's ``step`` fans one logical tick out to every
worker, and placement/eviction/scaling decisions depend only on message
contents, so a loopback fleet is bit-for-bit deterministic. *Liveness*
is wall-clock -- heartbeat/step reply timeouts, the ``wall`` timestamp
riding fabric spans in proc mode -- and never feeds back into token
results, only into failover timing.

PyTorch port of ``repro.orchestrator.fabric``: the same codec (byte for
byte), worker, transports and router over the port's pods. A proc worker
is ``python -m repro_torch.orchestrator.fabric_worker``, its own process
with its own device context (``cuda:0`` unless the pod kwargs say
``platform="cpu"``). Three process details differ from the reference:
the reader thread marks the transport dead the moment the pipe hits EOF,
``close`` reaps a worker it had to kill, and a worker points its fd 1 at
stderr so only frames reach the pipe.
"""

from __future__ import annotations

import base64
import bisect
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from pathlib import Path
from queue import Empty, Queue
from typing import Callable, Iterable

import numpy as np

from repro_torch.orchestrator.obs.metrics import (MetricsRegistry,
                                                  merge_snapshots)
from repro_torch.orchestrator.obs.tracing import (TraceBuffer, dump_span_log,
                                                  load_span_log)
from repro_torch.orchestrator.pod import Pod
from repro_torch.orchestrator.request_queue import GenRequest
from repro_torch.orchestrator.router import _hash64
from repro_torch.orchestrator.scheduler import ContinuousScheduler

# frame marker: ASCII record separator. A worker's stdout may carry stray
# library output; only lines opening with the marker are protocol frames.
FRAME = b"\x1e"

FABRIC_POLICIES = ("shortest-queue", "consistent-hash")

# <runtime root>/spans/<name>.spans.json -- per-process span files, the
# cross-process half of the fleet-wide lifecycle closure check
SPAN_DIR = "spans"


def span_path(root, name: str) -> Path:
    return Path(root) / SPAN_DIR / f"{name}.spans.json"


# -- codec --------------------------------------------------------------------

def encode_frame(msg: dict) -> bytes:
    return FRAME + json.dumps(
        msg, separators=(",", ":"), sort_keys=True).encode() + b"\n"


def decode_frame(raw: bytes | str) -> dict | None:
    """The message in ``raw`` if it is a protocol frame, else None."""
    if isinstance(raw, str):
        raw = raw.encode()
    if not raw.startswith(FRAME):
        return None
    try:
        msg = json.loads(raw[len(FRAME):].decode())
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    return msg if isinstance(msg, dict) else None


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _unb64(s: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype).copy()


def encode_request(req: GenRequest) -> dict:
    """Wire form of a GenRequest, INCLUDING its resume state: a request
    re-routed off a dead pod ships its committed tokens so the survivor
    can suffix-re-prefill (prompt + tokens[:-1], cursor on tokens[-1])
    and continue token-for-token where the fleet last saw it."""
    return {
        "rid": req.rid,
        "prompt": _b64(np.asarray(req.prompt, np.int32)),
        "max_new_tokens": req.max_new_tokens,
        "eos_id": req.eos_id,
        "arrival": req.arrival,
        "frontend": None if req.frontend is None else {
            "shape": [int(d) for d in req.frontend.shape],
            "data": _b64(np.asarray(req.frontend, np.float32))},
        "prefix_len": req.prefix_len,
        "priority": req.priority,
        "deadline_ticks": req.deadline_ticks,
        "state": req.state,
        "tokens": [int(t) for t in req.tokens],
        "submit_tick": req.submit_tick,
        "admit_tick": req.admit_tick,
        "preemptions": req.preemptions,
        "reroutes": req.reroutes,
    }


def decode_request(doc: dict) -> GenRequest:
    fe = doc.get("frontend")
    if fe is not None:
        fe = _unb64(fe["data"], np.float32).reshape(fe["shape"])
    req = GenRequest(
        rid=int(doc["rid"]),
        prompt=_unb64(doc["prompt"], np.int32),
        max_new_tokens=int(doc["max_new_tokens"]),
        eos_id=doc.get("eos_id"),
        arrival=int(doc.get("arrival", 0)),
        frontend=fe,
        prefix_len=int(doc.get("prefix_len", 0)),
        priority=doc.get("priority", "interactive"),
        deadline_ticks=doc.get("deadline_ticks"))
    # resume state rides outside the constructor: these fields are owned
    # by the scheduler/engine at runtime, the codec just moves them
    req.state = doc.get("state", "queued")
    req.tokens = [int(t) for t in doc.get("tokens", [])]
    req.submit_tick = int(doc.get("submit_tick", -1))
    req.admit_tick = int(doc.get("admit_tick", -1))
    req.preemptions = int(doc.get("preemptions", 0))
    req.reroutes = int(doc.get("reroutes", 0))
    return req


def encode_final(req: GenRequest) -> dict:
    """Terminal-state payload streamed back to the router: authoritative
    final fields for the CALLER's request object."""
    return {
        "rid": req.rid,
        "state": req.state,
        "tokens": [int(t) for t in req.tokens],
        "finish_reason": req.finish_reason,
        "error": req.error,
        "submit_tick": req.submit_tick,
        "admit_tick": req.admit_tick,
        "done_tick": req.done_tick,
        "replica": req.replica,
        "slot": req.slot,
        "preemptions": req.preemptions,
    }


# -- pod side -----------------------------------------------------------------

class PodWorker:
    """One pod behind the message protocol.

    Owns a ``Pod`` + ``ContinuousScheduler`` and answers the router's
    frames; runs unchanged in-process (LoopbackTransport) or as the body
    of a worker subprocess (``python -m
    repro_torch.orchestrator.fabric_worker --worker``). Joins the fleet's
    tick domain at ``start_tick`` so a pod spawned mid-run (elastic
    scale-up) stamps admits/completions on the same clock as the rest of
    the fleet."""

    def __init__(self, runtime, image, *, pod_id: str,
                 start_tick: int = 0, fairness_cap: int = 4,
                 pod_kwargs: dict | None = None, wall_clock: bool = False):
        self.runtime = runtime
        self.pod = Pod(runtime, image, pod_id=pod_id,
                       **dict(pod_kwargs or {}))
        self.sched = ContinuousScheduler(self.pod,
                                         fairness_cap=fairness_cap)
        self.sched.tick = int(start_tick)
        self.wall_clock = bool(wall_clock)
        self._inflight: dict[int, GenRequest] = {}
        self._tok_sent: dict[int, int] = {}
        self._adm_sent: set[int] = set()
        # at-least-once finals: a terminal payload stays here (and rides
        # every subsequent events reply) until the router acks the rid on
        # a later step message -- a reply lost to a flapping link must
        # not lose a completion, and duplicate finals are idempotent on
        # the router side
        self._finals: dict[int, dict] = {}
        self.span_file = span_path(runtime.root, pod_id)

    def _caps(self) -> list[dict]:
        """Engine capability descriptors: everything the router needs to
        answer ``fits`` remotely (mirrors ``SlotEngine.fits``)."""
        return [{
            "n_slots": e.n_slots,
            "fe_len": e.fe_len,
            "d_model": e.d_model,
            "max_len": e.max_len,
            "chunk": e.chunk,
            "paged": e.paged,
            "page_size": e.page_size if e.paged else 0,
            "capacity": e.pool.capacity if e.paged else 0,
        } for e in self.pod.engines]

    def _wall(self) -> float | None:
        return time.time() if self.wall_clock else None

    def flush(self) -> None:
        """State file + span file refresh: what `repro top --watch` and
        the cross-process closure check read while the run is live."""
        self.pod.write_state()
        dump_span_log(self.pod.trace, self.span_file)

    def handle(self, msg: dict) -> dict | None:
        t = msg.get("t")
        if t == "hello":
            return {"t": "ready", "pod": self.pod.pod_id,
                    "tick": self.sched.tick, "pid": os.getpid(),
                    "caps": self._caps()}
        if t == "submit":
            req = decode_request(msg["req"])
            self._inflight[req.rid] = req
            self._tok_sent[req.rid] = len(req.tokens)
            if req.state == "preempted" and req.tokens:
                # re-routed mid-decode: enters through the resume path
                # (front of its lane, suffix re-prefill at admission)
                self.sched.queue.requeue(req)
            else:
                submit0 = req.submit_tick
                req.state, req.tokens = "queued", []
                self.sched.submit(req)
                if submit0 >= 0:
                    # a fresh RE-submission after a pod death keeps its
                    # original submit stamp so queue-latency accounting
                    # spans the whole fleet-level wait, not the failover
                    req.submit_tick = submit0
            return None
        if t == "step":
            for rid in msg.get("ack", ()):
                self._finals.pop(int(rid), None)
            for _ in range(int(msg.get("n", 1))):
                self.sched.step()
            events = self._events()
            if events["done"]:
                # flush BEFORE replying: once the router learns a request
                # reached a terminal state, that terminal span is already
                # on disk -- a kill between flush and reply just leaves
                # the request assigned, and re-routing covers it
                self.flush()
            return events
        if t == "hb":
            self.flush()
            return {"t": "beat", "pod": self.pod.pod_id,
                    "tick": self.sched.tick,
                    "pending": self.sched.queue.pending,
                    "active": sum(len(e.active)
                                  for e in self.pod.engines),
                    "wall": self._wall(),
                    "metrics": self.pod.metrics.snapshot()}
        if t == "retire":
            self.pod.write_state(final=True)
            dump_span_log(self.pod.trace, self.span_file)
            return {"t": "bye", "pod": self.pod.pod_id}
        return {"t": "error", "pod": self.pod.pod_id,
                "error": f"unknown message type {t!r}"}

    def _events(self) -> dict:
        """Everything that changed since the last report: new tokens per
        in-flight request (the token stream), first-admission ticks, and
        full final payloads for requests that reached a terminal state."""
        toks: dict[str, list[int]] = {}
        adm: list[list[int]] = []
        for rid in sorted(self._inflight):
            req = self._inflight[rid]
            sent = self._tok_sent[rid]
            if len(req.tokens) > sent:
                toks[str(rid)] = [int(x) for x in req.tokens[sent:]]
                self._tok_sent[rid] = len(req.tokens)
            if req.admit_tick >= 0 and rid not in self._adm_sent:
                adm.append([rid, req.admit_tick])
                self._adm_sent.add(rid)
        for rid in sorted(self._inflight):
            req = self._inflight[rid]
            if req.state in ("done", "rejected", "shed"):
                self._finals[rid] = encode_final(req)
                del self._inflight[rid]
                del self._tok_sent[rid]
                self._adm_sent.discard(rid)
        # every unacked final rides every reply (at-least-once delivery)
        done = [self._finals[rid] for rid in sorted(self._finals)]
        return {"t": "events", "pod": self.pod.pod_id,
                "tick": self.sched.tick, "toks": toks, "adm": adm,
                "done": done, "pending": self.sched.queue.pending,
                "active": sum(len(e.active) for e in self.pod.engines)}


# -- transports ---------------------------------------------------------------

class LoopbackTransport:
    """In-memory transport: frames round-trip through the codec exactly
    as on a pipe, delivery is synchronous, and everything is
    deterministic. ``kill`` simulates SIGKILL (dead + inbox gone);
    ``muted`` drops the next N replies (the worker still processes the
    message -- a flapping network link, not a dead host)."""

    def __init__(self, worker: PodWorker):
        self.worker = worker
        self.alive = True
        self.muted = 0
        self._inbox: deque[dict] = deque()

    @property
    def pid(self) -> int | None:
        return None

    def send(self, msg: dict) -> None:
        if not self.alive:
            raise BrokenPipeError("loopback transport is dead")
        reply = self.worker.handle(decode_frame(encode_frame(msg)))
        if reply is None:
            return
        if self.muted > 0:
            self.muted -= 1
            return
        self._inbox.append(decode_frame(encode_frame(reply)))

    def recv(self, timeout: float | None = None) -> dict | None:
        if self._inbox:
            return self._inbox.popleft()
        return None

    def kill(self) -> None:
        self.alive = False
        self._inbox.clear()

    def close(self) -> None:
        self.alive = False


class ProcTransport:
    """Process-per-pod transport over stdin/stdout pipes.

    A daemon reader thread pumps protocol frames off the worker's stdout
    into a queue (non-frame lines -- stray library prints -- are
    skipped). EOF or a broken pipe flips ``alive`` immediately, so a
    kill -9'd worker is detected the moment the pipe collapses instead
    of after a timeout. The worker's stderr is the parent's."""

    def __init__(self, argv: list[str], env: dict | None = None):
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env)
        self.alive = True
        self._q: Queue = Queue()
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _pump(self) -> None:
        for raw in self.proc.stdout:
            msg = decode_frame(raw)
            if msg is not None:
                self._q.put(msg)
        # EOF: the worker is gone. Dead at once (the next sweep evicts it
        # without a probe); the sentinel wakes a recv that is waiting
        self.alive = False
        self._q.put(None)

    def send(self, msg: dict) -> None:
        try:
            self.proc.stdin.write(encode_frame(msg))
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            self.alive = False
            raise BrokenPipeError(f"worker pid {self.proc.pid} is gone")

    def recv(self, timeout: float | None = None) -> dict | None:
        try:
            msg = self._q.get(timeout=timeout)
        except Empty:
            return None
        if msg is None:
            self.alive = False
            return None
        return msg

    def kill(self) -> None:
        """SIGKILL -- the fault-injection primitive: no cleanup, no
        flush, the worker's state is simply gone."""
        self.alive = False
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass

    def close(self) -> None:
        self.alive = False
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            # stuck (e.g. mid-kernel on a wedged device): kill, then reap
            self.kill()
            self.proc.wait()


def loopback_spawner(runtime, image, *, pod_kwargs: dict | None = None,
                     fairness_cap: int = 4) -> Callable:
    """Spawn callable for an in-process fleet (tests, parity baselines)."""
    def spawn(pod_id: str, start_tick: int) -> LoopbackTransport:
        return LoopbackTransport(PodWorker(
            runtime, image, pod_id=pod_id, start_tick=start_tick,
            fairness_cap=fairness_cap, pod_kwargs=pod_kwargs))
    return spawn


def proc_spawner(root, *, imagefile: str | None = None,
                 ref: str | None = None,
                 pod_kwargs: dict | None = None, fairness_cap: int = 4,
                 python: str | None = None) -> Callable:
    """Spawn callable launching one worker PROCESS per pod. The worker
    re-opens the same runtime root (registry, compile cache, state dir)
    and resolves the image itself: an ``imagefile`` text is rebuilt
    (content-addressed -- every worker lands on the identical digest the
    parent built), a registry ``ref`` is pulled."""
    if (imagefile is None) == (ref is None):
        raise ValueError("proc_spawner needs exactly one of imagefile=/"
                         "ref=")
    def spawn(pod_id: str, start_tick: int) -> ProcTransport:
        cfg = {"root": str(root), "imagefile": imagefile, "ref": ref,
               "pod_id": pod_id, "start_tick": int(start_tick),
               "fairness_cap": int(fairness_cap),
               "pod": dict(pod_kwargs or {})}
        argv = [python or sys.executable, "-m",
                "repro_torch.orchestrator.fabric_worker", "--worker",
                "--config", json.dumps(cfg)]
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        pp = env.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        return ProcTransport(argv, env=env)
    return spawn


# -- router side --------------------------------------------------------------

class FabricMember:
    """Router-side record of one remote pod: transport + capability
    descriptors + the liveness/load state the router tracks for it."""

    def __init__(self, pod_id: str, ordinal: int, transport):
        self.pod_id = pod_id
        self.ordinal = ordinal
        self.transport = transport
        self.caps: list[dict] = []
        self.outstanding = 0            # routed token budgets not finished
        self.missed = 0                 # consecutive unanswered probes
        self.assigned: dict[int, GenRequest] = {}
        self.to_ack: set[int] = set()   # finals to ack on the next step
        self.draining = False
        self.last_beat = -1             # router tick of the last beat
        self.last_wall: float | None = None
        self.tick = 0                   # worker tick at last reply
        self.pending = 0
        self.active = 0
        self.metrics_snapshot: dict | None = None

    @property
    def srid(self) -> int:
        """Synthetic rid for this member's heartbeat/evict span log:
        negative so it can never collide with user requests."""
        return -1 - self.ordinal

    @property
    def alive(self) -> bool:
        return self.transport.alive

    @property
    def capacity(self) -> int:
        return sum(c["n_slots"] for c in self.caps)


class FabricRouter:
    """PodRouter's surface (submit/step/run/drain_pod/status) over a
    fleet of transport-connected workers.

    One router ``step()`` = one fleet tick: probe heartbeats (every
    ``heartbeat_every`` ticks), evict members whose transport died or
    that missed ``miss_limit`` consecutive probes, heal/scale the fleet,
    route arrived requests, then fan the tick out to every live worker
    and fold their event streams back into the caller's request objects.

    Eviction re-routes the dead member's in-flight requests EXACTLY once
    each: requests with committed tokens are shipped to a survivor as
    preempted (the resume path re-prefills prompt + tokens[:-1] and
    continues from tokens[-1] -- greedy decode makes the continuation
    bitwise-identical to an unkilled run), token-less ones are
    re-submitted fresh. A flapping member (missed < miss_limit, then a
    beat) is never evicted, so its work is never duplicated."""

    STATE_EVERY = 8

    def __init__(self, spawn: Callable, *, runtime, pods: int = 2,
                 min_pods: int = 1, max_pods: int | None = None,
                 policy: str = "shortest-queue", fleet: str = "fab",
                 vnodes: int = 64, heartbeat_every: int = 4,
                 miss_limit: int = 2, hb_timeout: float = 10.0,
                 rpc_timeout: float = 120.0, boot_timeout: float = 300.0,
                 scale_up_tokens: int | None = None,
                 scale_idle_ticks: int | None = None,
                 wall_clock: bool = False):
        if policy not in FABRIC_POLICIES:
            raise ValueError(f"unknown fabric policy {policy!r}; "
                             f"choose from {FABRIC_POLICIES}")
        if pods < 1 or min_pods < 1:
            raise ValueError("a fabric needs at least one pod")
        self.spawn = spawn
        self.runtime = runtime
        self.policy = policy
        self.fleet = fleet
        self.min_pods = int(min_pods)
        self.max_pods = int(max_pods) if max_pods else max(pods, min_pods)
        self.vnodes = int(vnodes)
        self.heartbeat_every = int(heartbeat_every)
        self.miss_limit = int(miss_limit)
        self.hb_timeout = float(hb_timeout)
        self.rpc_timeout = float(rpc_timeout)
        self.boot_timeout = float(boot_timeout)
        self.scale_up_tokens = scale_up_tokens
        self.scale_idle_ticks = scale_idle_ticks
        self.wall_clock = bool(wall_clock)
        self.router_id = f"fabric-{uuid.uuid4().hex[:8]}"
        self.tick = 0
        self._state_tick = -self.STATE_EVERY
        self._ordinal = 0
        self._idle_streak = 0
        self.members: dict[str, FabricMember] = {}
        self._ring: list[tuple[int, str]] = []
        self._ring_keys: list[int] = []
        self._staged: list[GenRequest] = []
        self._reroute: deque[tuple[GenRequest, str]] = deque()
        # loopback only: evicted/retired workers' span buffers, retained
        # so the fleet closure check sees terminals recorded before the
        # death (proc workers persist the same spans as FILES at each
        # heartbeat -- this is the in-process analog, not extra state)
        self._dead_buffers: list[TraceBuffer] = []
        self.completed: list[GenRequest] = []
        self.rejected: list[GenRequest] = []
        self.shedded: list[GenRequest] = []
        self.metrics = MetricsRegistry()
        self.trace = TraceBuffer(name=self.router_id)
        self._c_routed = self.metrics.counter("routed", policy=policy)
        self._c_spilled = self.metrics.counter("spillover", policy=policy)
        self._c_rejected = self.metrics.counter("rejected", policy=policy)
        self._c_req_rejected = self.metrics.counter("requests_rejected")
        self._c_shed = self.metrics.counter("shed", policy=policy)
        self._c_req_shed = self.metrics.counter("requests_shed")
        self._c_heartbeats = self.metrics.counter("fabric_heartbeats")
        self._c_evictions = self.metrics.counter("fabric_evictions")
        self._c_reroutes = self.metrics.counter("fabric_reroutes")
        self._c_spawned = self.metrics.counter("fabric_pods_spawned")
        self._c_retired = self.metrics.counter("fabric_pods_retired")
        # span files are per-FLEET state: wipe this fleet's leftovers from
        # a previous run in the same root, or a stale router file's routes
        # (whose terminals lived in since-overwritten worker files) would
        # fail the closure check. Concurrent fleets in one root must use
        # distinct ``fleet`` names.
        spans_dir = Path(self.runtime.root) / SPAN_DIR
        if spans_dir.exists():
            for p in spans_dir.glob(f"{self.fleet}-*.spans.json"):
                p.unlink()
        # boot the initial fleet: spawn all transports first (worker
        # processes import/build in parallel), then handshake each
        fresh = [self._new_member() for _ in range(int(pods))]
        for m in fresh:
            m.transport.send({"t": "hello"})
        for m in fresh:
            self._handshake(m)
        self._rebuild_ring()
        self.write_state()

    # -- membership ----------------------------------------------------------
    def _now(self) -> float | None:
        return time.time() if self.wall_clock else None

    def _new_member(self) -> FabricMember:
        pod_id = f"{self.fleet}-{self._ordinal}"
        m = FabricMember(pod_id, self._ordinal,
                         self.spawn(pod_id, self.tick))
        self._ordinal += 1
        self.members[pod_id] = m
        self._c_spawned.inc()
        return m

    def _handshake(self, m: FabricMember) -> None:
        ready = None
        while ready is None:
            reply = m.transport.recv(self.boot_timeout)
            if reply is None:
                break
            if reply.get("t") == "ready" and reply.get("pod") == m.pod_id:
                ready = reply
        if ready is None:
            raise RuntimeError(
                f"fabric member {m.pod_id} never answered hello "
                f"(boot timeout {self.boot_timeout}s)")
        m.caps = ready["caps"]
        m.tick = ready["tick"]

    def _spawn_member(self) -> FabricMember:
        m = self._new_member()
        m.transport.send({"t": "hello"})
        self._handshake(m)
        self._rebuild_ring()
        self.write_state()
        return m

    def _rebuild_ring(self) -> None:
        ring = [(_hash64(f"{pod_id}#{v}"), pod_id)
                for pod_id in self.members for v in range(self.vnodes)]
        self._ring = sorted(ring, key=lambda t: t[0])
        self._ring_keys = [h for h, _ in self._ring]

    def drain_pod(self, pod_id: str) -> None:
        """Route new traffic around a member; its in-flight work finishes
        normally. The retire path (elastic scale-down) goes through here
        first, mirroring ``PodRouter.drain_pod``."""
        self.members[pod_id].draining = True
        self.write_state()

    def undrain_pod(self, pod_id: str) -> None:
        self.members[pod_id].draining = False
        self.write_state()

    # -- rpc ------------------------------------------------------------------
    def _rpc(self, m: FabricMember, msg: dict, want: str,
             timeout: float) -> dict | None:
        """Send + await the matching reply. Stale frames from an earlier
        timed-out exchange are not lost: late ``events`` are applied (the
        token stream must never drop), anything else is drained."""
        try:
            m.transport.send(msg)
        except (BrokenPipeError, OSError):
            return None
        while True:
            reply = m.transport.recv(timeout)
            if reply is None:
                return None
            if reply.get("pod") != m.pod_id:
                continue
            if reply.get("t") == want:
                return reply
            if reply.get("t") == "events":
                self.completed.extend(self._apply_events(m, reply))

    # -- heartbeats + eviction ------------------------------------------------
    def _heartbeat_all(self) -> None:
        for m in list(self.members.values()):
            if not m.alive:
                continue
            beat = self._rpc(m, {"t": "hb", "tick": self.tick}, "beat",
                             self.hb_timeout)
            if beat is None:
                m.missed += 1
                continue
            m.missed = 0
            m.last_beat = self.tick
            m.last_wall = beat.get("wall")
            m.tick = beat["tick"]
            m.pending = beat["pending"]
            m.active = beat["active"]
            m.metrics_snapshot = beat.get("metrics")
            self._c_heartbeats.inc()
            self.trace.record(m.srid, "heartbeat", self.tick,
                              wall=self._now(), pod=m.pod_id,
                              pending=m.pending, active=m.active)

    def _evict_dead(self) -> None:
        for m in list(self.members.values()):
            if not m.alive or m.missed >= self.miss_limit:
                self._evict(m)

    def _evict(self, m: FabricMember) -> None:
        """Remove a dead member from ring + ledger and queue its in-flight
        requests for exactly-once re-routing to survivors."""
        self.trace.record(m.srid, "evict", self.tick, wall=self._now(),
                          pod=m.pod_id, missed=m.missed,
                          inflight=len(m.assigned),
                          outstanding=m.outstanding)
        self._c_evictions.inc()
        self._keep_buffer(m)
        del self.members[m.pod_id]
        self._rebuild_ring()
        m.transport.kill()
        for rid in sorted(m.assigned):
            req = m.assigned[rid]
            req.reroutes += 1
            req.pod = req.replica = None
            req.slot = None
            # committed tokens -> the survivor resumes via suffix
            # re-prefill; nothing committed -> plain re-submission
            req.state = "preempted" if req.tokens else "queued"
            self._reroute.append((req, m.pod_id))
        m.assigned.clear()
        m.outstanding = 0
        self.write_state()

    # -- elastic fleet --------------------------------------------------------
    def _autoscale(self) -> None:
        live = [m for m in self.members.values() if not m.draining]
        # heal: never serve below the floor (or with zero routable pods)
        while len(self.members) < self.min_pods or not live:
            live.append(self._spawn_member())
        arrived = sum(r.max_new_tokens for r in self._staged
                      if r.arrival <= self.tick)
        backlog = sum(m.outstanding for m in live) + arrived \
            + sum(r.max_new_tokens for r, _ in self._reroute)
        if (self.scale_up_tokens and len(self.members) < self.max_pods
                and backlog > self.scale_up_tokens * len(live)):
            self._spawn_member()
        if backlog == 0 and not self._staged:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if (self.scale_idle_ticks
                and self._idle_streak >= self.scale_idle_ticks
                and len(self.members) > self.min_pods):
            victim = max((m for m in self.members.values()
                          if not m.draining), default=None,
                         key=lambda m: m.ordinal)
            if victim is not None:
                self.drain_pod(victim.pod_id)
        for m in list(self.members.values()):
            if m.draining and not m.assigned \
                    and len(self.members) > self.min_pods:
                self._retire(m)

    def _retire(self, m: FabricMember) -> None:
        """Graceful scale-down: final state/span flush, then goodbye."""
        self._rpc(m, {"t": "retire"}, "bye", self.hb_timeout)
        m.transport.close()
        self._keep_buffer(m)
        del self.members[m.pod_id]
        self._rebuild_ring()
        self._c_retired.inc()
        self.write_state()

    # -- placement ------------------------------------------------------------
    @staticmethod
    def _cap_fits(cap: dict, req: GenRequest) -> bool:
        """Remote ``SlotEngine.fits``, answered from the capability
        descriptor the worker sent at hello."""
        if req.frontend is not None:
            if not cap["fe_len"] or req.frontend_len > cap["fe_len"] \
                    or req.frontend.shape[1] != cap["d_model"]:
                return False
        span = cap["fe_len"] + req.prompt_len + req.max_new_tokens
        if span + cap["chunk"] > cap["max_len"]:
            return False
        if cap["paged"]:
            pages = -(-(span + cap["chunk"]) // cap["page_size"])
            if pages > cap["capacity"]:
                return False
        return True

    def _member_fits(self, m: FabricMember, req: GenRequest) -> bool:
        return m.alive and any(self._cap_fits(c, req) for c in m.caps)

    def _candidates(self, req: GenRequest) -> list[FabricMember]:
        if self.policy == "consistent-hash":
            i = (bisect.bisect_right(self._ring_keys,
                                     _hash64(f"rid:{req.rid}"))
                 if self._ring else 0)
            order, seen = [], set()
            for k in range(len(self._ring)):
                pod_id = self._ring[(i + k) % len(self._ring)][1]
                if pod_id not in seen:
                    seen.add(pod_id)
                    order.append(self.members[pod_id])
                    if len(order) == len(self.members):
                        break
        else:
            order = sorted(self.members.values(),
                           key=lambda m: (m.outstanding, m.ordinal))
        return ([m for m in order if not m.draining]
                + [m for m in order if m.draining])

    def _route_one(self, req: GenRequest, src: str | None) -> None:
        order = self._candidates(req)
        chosen = next((m for m in order if self._member_fits(m, req)),
                      None)
        if chosen is None:
            req.state, req.finish_reason = "rejected", "oversized"
            req.error = "no fabric member can ever fit this request"
            req.done_tick = self.tick
            self.rejected.append(req)
            self._c_rejected.inc()
            self._c_req_rejected.inc()
            self.trace.record(req.rid, "reject", self.tick,
                              wall=self._now(), reason="infeasible",
                              policy=self.policy)
            return
        req.pod = chosen.pod_id
        if src is None:
            req.spilled = chosen is not order[0]
            if req.spilled:
                self._c_spilled.inc()
            self._c_routed.inc()
            self.trace.record(req.rid, "route", self.tick,
                              wall=self._now(), pod=chosen.pod_id,
                              policy=self.policy, spilled=req.spilled)
        else:
            self._c_reroutes.inc()
            self.trace.record(req.rid, "reroute", self.tick,
                              wall=self._now(), src=src,
                              pod=chosen.pod_id,
                              tokens_done=len(req.tokens))
        try:
            chosen.transport.send({"t": "submit",
                                   "req": encode_request(req)})
        except (BrokenPipeError, OSError):
            # died between probe and placement: park the request for the
            # next pass, the eviction sweep will reclaim the member
            req.reroutes += 1
            self._reroute.append((req, chosen.pod_id))
            return
        chosen.assigned[req.rid] = req
        chosen.outstanding += req.max_new_tokens

    def _route_staged(self) -> None:
        work: list[tuple[GenRequest, str | None]] = []
        while self._reroute:
            work.append(self._reroute.popleft())
        still: list[GenRequest] = []
        for req in self._staged:
            if req.arrival <= self.tick:
                work.append((req, None))
            else:
                still.append(req)
        self._staged = still
        for req, src in work:
            self._route_one(req, src)

    # -- submit / step / run --------------------------------------------------
    def submit(self, reqs: Iterable[GenRequest] | GenRequest) -> None:
        """Stage requests for routing; placement happens at the tick
        their ``arrival`` is due, against the LIVE membership -- a pod
        spawned by scale-up takes arrivals a static router would have
        piled onto the original fleet."""
        if isinstance(reqs, GenRequest):
            reqs = [reqs]
        self._staged.extend(reqs)

    def _step_all(self) -> list[GenRequest]:
        done: list[GenRequest] = []
        for m in sorted(self.members.values(), key=lambda m: m.ordinal):
            if not m.alive:
                continue
            msg = {"t": "step", "n": 1, "ack": sorted(m.to_ack)}
            m.to_ack.clear()
            r = self._rpc(m, msg, "events", self.rpc_timeout)
            if r is None:
                m.missed += 1
                continue
            m.missed = 0
            m.tick = r["tick"]
            m.pending = r["pending"]
            m.active = r["active"]
            done.extend(self._apply_events(m, r))
        return done

    def _apply_events(self, m: FabricMember, r: dict) -> list[GenRequest]:
        """Fold one worker's event stream into the caller's request
        objects: append streamed tokens (the router's view IS the
        fleet's committed state -- what a survivor resumes from), stamp
        first admissions, finalize terminal requests and settle the
        outstanding-token ledger."""
        for rid_s in sorted(r["toks"], key=int):
            req = m.assigned.get(int(rid_s))
            if req is not None:
                req.tokens.extend(int(t) for t in r["toks"][rid_s])
        for rid, adm in r["adm"]:
            req = m.assigned.get(int(rid))
            if req is not None and req.admit_tick < 0:
                req.admit_tick = int(adm)
        finished: list[GenRequest] = []
        for fin in r["done"]:
            # at-least-once finals: ack every delivery (the worker keeps
            # re-sending until acked) and apply each rid exactly once
            m.to_ack.add(int(fin["rid"]))
            req = m.assigned.pop(int(fin["rid"]), None)
            if req is None:
                continue
            m.outstanding -= req.max_new_tokens
            req.tokens[:] = [int(t) for t in fin["tokens"]]
            req.state = fin["state"]
            req.finish_reason = fin["finish_reason"]
            req.error = fin["error"]
            req.admit_tick = int(fin["admit_tick"])
            req.done_tick = int(fin["done_tick"])
            req.replica = fin["replica"]
            req.slot = fin["slot"]
            req.preemptions = int(fin["preemptions"])
            if req.state == "done":
                finished.append(req)
            elif req.state == "rejected":
                self.rejected.append(req)
                self._c_rejected.inc()
                self._c_req_rejected.inc()
            elif req.state == "shed":
                self.shedded.append(req)
                self._c_shed.inc()
                self._c_req_shed.inc()
        return finished

    def step(self) -> list[GenRequest]:
        """One fleet tick: probe -> evict -> heal/scale -> route -> fan
        the tick out and fold the event streams back."""
        if self.heartbeat_every and self.tick % self.heartbeat_every == 0:
            self._heartbeat_all()
        self._evict_dead()
        self._autoscale()
        self._route_staged()
        done = self._step_all()
        self.completed.extend(done)
        self.tick += 1
        # unconditional cadence (not activity-gated like PodRouter): a
        # live `repro top --watch` must see the fleet move even when no
        # request completed this window
        if self.tick - self._state_tick >= self.STATE_EVERY:
            self.write_state()
            self._state_tick = self.tick
        return done

    @property
    def busy(self) -> bool:
        return bool(self._staged or self._reroute
                    or any(m.assigned for m in self.members.values()))

    def run(self, max_ticks: int | None = None) -> list[GenRequest]:
        start = self.tick
        while self.busy:
            if max_ticks is not None and self.tick - start >= max_ticks:
                break
            self.step()
        self.write_state()
        return self.completed

    def close(self) -> None:
        """Graceful shutdown: retire every member (final state + span
        flush on each), then stamp the router's own terminal state."""
        for m in sorted(self.members.values(), key=lambda m: m.ordinal):
            if m.alive:
                self._rpc(m, {"t": "retire"}, "bye", self.hb_timeout)
            m.transport.close()
            self._keep_buffer(m)
        self.members.clear()
        self._rebuild_ring()
        self.write_state(final=True)

    # -- accounting / state ---------------------------------------------------
    @property
    def outstanding_total(self) -> int:
        """Ledger sum: token budgets routed and not yet finished. After a
        drained run this is exactly 0 -- the conservation invariant the
        ledger regression test pins."""
        return sum(m.outstanding for m in self.members.values())

    @property
    def capacity(self) -> int:
        return sum(m.capacity for m in self.members.values()
                   if not m.draining)

    @property
    def live(self) -> int:
        return sum(1 for m in self.members.values() if m.alive)

    @property
    def pending(self) -> int:
        return (len(self._staged) + len(self._reroute)
                + sum(m.pending for m in self.members.values()))

    def _keep_buffer(self, m: FabricMember) -> None:
        w = getattr(m.transport, "worker", None)
        if w is not None:
            self._dead_buffers.append(w.pod.trace)

    def trace_buffers(self) -> list[TraceBuffer]:
        """Router buffer + every LOCAL (loopback) worker's pod buffer,
        including evicted/retired members'. Proc-mode worker spans live
        in their span files instead -- see ``load_fleet_spans``."""
        out = [self.trace]
        for m in sorted(self.members.values(), key=lambda m: m.ordinal):
            w = getattr(m.transport, "worker", None)
            if w is not None:
                out.append(w.pod.trace)
        return out + list(self._dead_buffers)

    def status(self) -> dict:
        return {
            "kind": "router",
            "router": self.router_id,
            "fabric": {
                "fleet": self.fleet,
                "live": self.live,
                "min_pods": self.min_pods,
                "max_pods": self.max_pods,
                "heartbeat_every": self.heartbeat_every,
                "miss_limit": self.miss_limit,
                "evictions": self._c_evictions.value,
                "reroutes": self._c_reroutes.value,
                "spawned": self._c_spawned.value,
                "retired": self._c_retired.value,
            },
            "policy": self.policy,
            "pods": list(self.members),
            "draining": sorted(m.pod_id for m in self.members.values()
                               if m.draining),
            "capacity": self.capacity,
            "free_slots": max(
                0, self.capacity - sum(m.active
                                       for m in self.members.values())),
            "pending": self.pending,
            "routed": self._c_routed.value,
            "spilled": self._c_spilled.value,
            "completed": len(self.completed),
            "rejected": len(self.rejected),
            "shed": len(self.shedded),
            "by_policy": {self.policy: {
                "routed": self._c_routed.value,
                "spillover": self._c_spilled.value,
                "rejected": self._c_rejected.value,
                "shed": self._c_shed.value,
            }},
            "metrics": merge_snapshots(
                [self.metrics.snapshot()]
                + [m.metrics_snapshot for m in self.members.values()
                   if m.metrics_snapshot]),
            "trace": self.trace.status(),
            "pid": os.getpid(),
            "members": [{
                "pod": m.pod_id,
                "live": m.alive,
                "missed": m.missed,
                "last_beat": m.last_beat,
                "last_wall": m.last_wall,
                "worker_pid": m.transport.pid,
                "capacity": m.capacity,
                "outstanding": m.outstanding,
                "inflight": len(m.assigned),
                "pending": m.pending,
                "active": m.active,
                "draining": m.draining,
            } for m in sorted(self.members.values(),
                              key=lambda m: m.ordinal)],
        }

    def write_state(self, final: bool = False) -> Path:
        """Same dir + atomic protocol as ``Pod.write_state``; also
        flushes the router's span file so the cross-process closure
        check always has the router-tier half."""
        d = Path(self.runtime.root) / "pods"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{self.router_id}.json"
        status = self.status()
        status["phase"] = ("exited" if final
                          else "serving" if any(
                              m.active for m in self.members.values())
                          else "idle")
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(status, indent=2))
        os.replace(tmp, p)
        dump_span_log(self.trace,
                      span_path(self.runtime.root,
                                f"{self.fleet}-router"))
        return p


def load_fleet_spans(root, fleet: str | None = None) -> list[TraceBuffer]:
    """Every per-process span file under ``<root>/spans/`` (router's own
    included), rehydrated -- the input to ``validate_fleet_closure`` for
    a proc-mode run. ``fleet`` narrows to one fleet's files (worker files
    are ``<fleet>-<ordinal>``, the router's is ``<fleet>-router``)."""
    d = Path(root) / SPAN_DIR
    if not d.exists():
        return []
    pat = f"{fleet}-*.spans.json" if fleet else "*.spans.json"
    return [load_span_log(p) for p in sorted(d.glob(pat))]


# -- worker entry point -------------------------------------------------------

def worker_main(cfg: dict) -> int:
    """Body of a worker subprocess: resolve the image (content-addressed
    rebuild of the imagefile, or a registry pull -- either way the digest
    the parent serves), serve the pod, answer frames on stdin until
    retire/EOF.

    The protocol owns file descriptor 1: the frames go to a duplicate of
    it, and fd 1 itself (``print``, native libraries, child processes
    such as a kernel build) is pointed at stderr, so no stray write can
    land mid-line in the frame stream."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    from repro_torch.core.runtime import Runtime
    rt = Runtime(cfg["root"])
    image = (rt.build(cfg["imagefile"]) if cfg.get("imagefile")
             else rt.pull(cfg["ref"]))
    worker = PodWorker(rt, image, pod_id=cfg["pod_id"],
                       start_tick=int(cfg.get("start_tick", 0)),
                       fairness_cap=int(cfg.get("fairness_cap", 4)),
                       pod_kwargs=cfg.get("pod") or {},
                       wall_clock=True)
    for raw in sys.stdin.buffer:
        msg = decode_frame(raw)
        if msg is None:
            continue
        reply = worker.handle(msg)
        if reply is not None:
            out.write(encode_frame(reply))
            out.flush()
        if msg.get("t") == "retire":
            return 0
    # EOF without retire: the router went away; flush and exit cleanly
    worker.flush()
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.orchestrator.fabric")
    ap.add_argument("--worker", action="store_true",
                    help="run as a pod worker (stdin/stdout frames)")
    ap.add_argument("--config", required=True,
                    help="worker config JSON (root, imagefile, pod_id, "
                         "start_tick, fairness_cap, pod kwargs)")
    args = ap.parse_args(argv)
    if not args.worker:
        ap.error("only --worker mode is runnable; the router side is "
                 "driven by serve/benchmarks")
    return worker_main(json.loads(args.config))


if __name__ == "__main__":
    raise SystemExit(main())
