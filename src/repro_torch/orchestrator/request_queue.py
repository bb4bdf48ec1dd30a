"""Request admission: priority-lane FIFO queue with arrival times.

``GenRequest`` is one generation job (prompt + decode budget). The queue
keeps one FIFO lane per priority class (``interactive`` ahead of
``batch``): admission is strictly in submission order WITHIN a class, and
an arrived interactive head always goes before an arrived batch head --
the QoS split that keeps latency-sensitive traffic from queueing behind
bulk work under overload. Requests that have not *arrived* yet
(``arrival`` is a tick stamp, letting benchmarks replay staggered traffic
deterministically) block only their own lane. The scheduler bounds
admissions per tick (``fairness_cap``) so a burst of new prompts cannot
stall in-flight decode indefinitely -- the classic continuous-batching
prefill/decode interleave.
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np

# admission preference order: interactive lanes drain first
PRIORITIES = ("interactive", "batch")


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int
    eos_id: int | None = None
    arrival: int = 0                    # earliest admission tick
    # modality prefix for frontend-embedding archs (musicgen/internvl2):
    # (fe_len, d_model) float embeddings consumed AHEAD of the token prompt.
    # None = unconditional generation (valid on frontend archs too); any
    # non-None prefix is rejected by text-only engines at admission.
    frontend: np.ndarray | None = None
    # declared SHARED leading token block (e.g. a fleet-wide system prompt):
    # prompt[:prefix_len] is eligible for copy-on-write prefix-page sharing
    # on paged engines, keyed by prefix_digest (md5 over the block, computed
    # here; placement can hash on it -- see PodRouter's prefix-hash policy).
    # 0 = nothing shareable. Clamped to prompt_len.
    prefix_len: int = 0
    prefix_digest: str | None = None    # derived; do not set manually
    # QoS class: "interactive" requests are admitted ahead of "batch"
    # requests, are never shed by the router's overload policy, and may
    # preempt a running batch request under pool pressure. "batch" is the
    # sheddable/preemptible bulk tier.
    priority: str = "interactive"
    # admission SLO: if set, the request must be ADMITTED (first token
    # sampled) within this many ticks of max(arrival, submit) or it is
    # shed at the admission site instead of serving a uselessly-late
    # response. None = no deadline.
    deadline_ticks: int | None = None

    # -- runtime state (owned by the scheduler/engine) ----------------------
    # queued | running | preempted | done | rejected | shed
    state: str = "queued"
    tokens: list[int] = field(default_factory=list)  # generated ids
    submit_tick: int = -1
    admit_tick: int = -1                # FIRST admission (TTFT anchor);
    done_tick: int = -1                 # resumes never move it
    replica: str | None = None
    slot: int | None = None
    finish_reason: str | None = None    # eos | length | oversized | shed
    #                                   # | deadline
    error: str | None = None            # human-readable rejection reason
    # page-level preemption record (owned by the scheduler): times this
    # request was paused mid-decode to release its pages to a
    # higher-priority admission, later resumed via suffix re-prefill
    preemptions: int = 0
    # router-tier placement record (owned by PodRouter): which pod the
    # request was routed to, and whether that was a spillover re-route
    # (the policy's preferred pod could never fit it, another pod could)
    pod: str | None = None
    spilled: bool = False
    # fabric-tier failover record (owned by FabricRouter): times this
    # request was re-routed off a dead pod to a survivor (resumed via
    # suffix re-prefill when tokens were already committed)
    reroutes: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: prompt must be 1-D, non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")
        if self.frontend is not None:
            self.frontend = np.asarray(self.frontend, np.float32)
            if self.frontend.ndim != 2 or self.frontend.shape[0] == 0:
                raise ValueError(
                    f"request {self.rid}: frontend must be a non-empty "
                    "(fe_len, d_model) array")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"request {self.rid}: priority must be one of {PRIORITIES}, "
                f"got {self.priority!r}")
        if self.deadline_ticks is not None and self.deadline_ticks < 0:
            raise ValueError(
                f"request {self.rid}: deadline_ticks must be >= 0")
        self.prefix_len = max(0, min(int(self.prefix_len), self.prompt_len))
        # the digest is the cache/placement KEY only; correctness never
        # rests on it (the pool compares the full block on lookup)
        self.prefix_digest = (hashlib.md5(
            self.prompt[:self.prefix_len].tobytes()).hexdigest()
            if self.prefix_len else None)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def frontend_len(self) -> int:
        return 0 if self.frontend is None else int(self.frontend.shape[0])


class RequestQueue:
    """Priority-lane admission queue: one FIFO deque per priority class.

    ``pop_ready`` preserves submission order WITHIN a class and prefers an
    arrived interactive head over an arrived batch head (strict priority,
    the overload behavior the SLO benchmark pins). Not-yet-arrived
    requests block only their own lane until their arrival tick (the
    queue is a trace replayer, not a reorderer). Preempted requests
    re-enter at the FRONT of their lane (``requeue``): they were admitted
    before everything still queued in that class, so resuming them first
    keeps per-class FIFO fairness."""

    def __init__(self):
        self._lanes: dict[str, deque[GenRequest]] = {
            p: deque() for p in PRIORITIES}
        self.submitted = 0
        self.admitted = 0

    def submit(self, req: GenRequest, tick: int = 0) -> None:
        if req.state != "queued":
            raise ValueError(f"request {req.rid} already {req.state}")
        req.submit_tick = tick
        self._lanes[req.priority].append(req)
        self.submitted += 1

    def requeue(self, req: GenRequest) -> None:
        """Re-enqueue a PREEMPTED request at the front of its lane for
        resume. Not a submission: submit stamps/counters are untouched."""
        if req.state != "preempted":
            raise ValueError(
                f"request {req.rid}: only preempted requests requeue "
                f"(state {req.state})")
        self._lanes[req.priority].appendleft(req)

    def __len__(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    @property
    def pending(self) -> int:
        return len(self)

    def pending_by_class(self) -> dict[str, int]:
        return {p: len(q) for p, q in self._lanes.items()}

    def _ready_lane(self, tick: int) -> deque[GenRequest] | None:
        for p in PRIORITIES:
            q = self._lanes[p]
            if q and q[0].arrival <= tick:
                return q
        return None

    def has_ready(self, tick: int) -> bool:
        return self._ready_lane(tick) is not None

    def peek_ready(self, tick: int) -> GenRequest | None:
        """Admission head (highest-priority arrived lane front) WITHOUT
        popping -- lets the scheduler hold the head under pool
        backpressure instead of reordering around it."""
        q = self._ready_lane(tick)
        return q[0] if q is not None else None

    def pop_ready(self, tick: int) -> GenRequest | None:
        """Next request in lane-priority FIFO order, or None if no lane
        head has arrived. The scheduler pops to admit AND to reject/shed,
        so ``admitted`` is counted at the admission site, not here."""
        q = self._ready_lane(tick)
        return q.popleft() if q is not None else None
