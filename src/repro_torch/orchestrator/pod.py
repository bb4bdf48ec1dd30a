"""Pod: N Container replicas of one immutable EnvImage, served as a unit.

The kubernetes/docker-compose analog over the repo's docker analog: a Pod
resolves a Registry ref ONCE (so every replica runs the identical image
digest, the paper's reproducibility contract), runs one Container per
replica, and gives each a SlotEngine. Replicas share the Runtime's
CompileCache, so replica 0 pays the trace+lower+compile cost and replicas
1..N-1 deserialize the executable -- the paper's import-problem fix applied
to fleet bring-up.

Pod state is persisted under ``<runtime root>/pods/<pod_id>.json`` so
``repro ps`` can show serving fleets next to containers.

PyTorch port of ``repro.orchestrator.pod``. ``params=`` serves given
weights (the port's tree, or the JAX package's as numpy) instead of a
seeded init; ``platform`` picks the device (``None`` -> the image's MESH
layer, ``local`` = cuda:0; ``"cpu"`` must be asked for).

``mesh=`` serves on a ``(data, model)`` mesh of torch.distributed ranks
(the port's analog of the reference's platform of that shape): every
rank builds the same Pod, each replica's Container holds the rank's
param shards and cache part, and every rank runs the same deterministic
scheduler over the same requests -- the model's collectives run inside
each step and the greedy tokens agree, so the host state (queue, page
pool, prefix registry, ticks) is the same on every rank. On a batch axis
above 1 each rank decodes its rows of the slot bank and every decode
gathers the sampled tokens over the batch axes (``SlotEngine``).
"""

from __future__ import annotations

import json
import os
import uuid
from pathlib import Path

from repro_torch.core.image import EnvImage
from repro_torch.orchestrator.obs.metrics import MetricsRegistry
from repro_torch.orchestrator.obs.tracing import TraceBuffer
from repro_torch.orchestrator.scheduler import SlotEngine


class Pod:
    def __init__(self, runtime, ref, *, replicas: int = 2, n_slots: int = 4,
                 max_len: int = 256, platform: str | None = None,
                 seed: int = 0, eos_id: int | None = None,
                 decode_chunk: int = 4, paged: bool = False,
                 page_size: int = 16, n_pages: int | None = None,
                 prefix_cache: bool = False,
                 spill_pages: int | None = 0,
                 pod_id: str | None = None, params=None, mesh=None):
        if replicas < 1:
            raise ValueError("a Pod needs at least one replica")
        self.mesh = mesh
        self.runtime = runtime
        self.ref = ref if isinstance(ref, str) else None
        self.image: EnvImage = (ref if isinstance(ref, EnvImage)
                                else runtime.pull(ref))
        self.platform = platform
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.decode_chunk = int(decode_chunk)
        # paged KV: every replica gets its own page pool of ``n_pages``
        # (None -> the HBM of a contiguous (n_slots, max_len) bank) and
        # max_len becomes the page-table span, not a memory reservation
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.n_pages = n_pages
        # copy-on-write prefix page sharing (paged only): each replica's
        # pool keeps a radix tree of shared prompt-prefix page blocks
        self.prefix_cache = bool(prefix_cache)
        # host-RAM spill tier for evicted prefix nodes: 0 disables (evict
        # outright), None is an unbounded store, >0 caps the store's pages
        self.spill_pages = spill_pages
        # callers may pin the id: the fabric assigns deterministic ids
        # (pod-0, pod-1, ...) so the consistent-hash ring and state files
        # are reproducible across worker processes and restarts
        self.pod_id = pod_id or f"pod-{uuid.uuid4().hex[:8]}"
        # one metrics registry + one span ring buffer per pod, shared by
        # every replica engine (labels keep the per-replica breakdown);
        # snapshots ride the state file so `ps`/`top` read live numbers
        self.metrics = MetricsRegistry()
        self.trace = TraceBuffer(name=self.pod_id)
        # pod-lifetime rejection counter, incremented by whichever scheduler
        # fronts this pod (a burst of rejections is a served-badly signal
        # `repro ps` must show even when no slot occupancy changed)
        self.rejected = 0
        # pod-lifetime QoS shed counter (admission-deadline misses charged
        # to this pod; router-tier overload sheds are counted at the router)
        self.shed = 0
        # router tier membership: PodRouter stamps its id here so `ps` can
        # read a fleet as one unit; None = standalone pod
        self.router: str | None = None
        self._params: dict[str, object] = {}   # image digest -> shared tree
        self._given_params = params             # served instead of an init
        self.engines: list[SlotEngine] = [
            self.make_engine(self.image, i) for i in range(replicas)]
        self.retired: list[SlotEngine] = []
        self.write_state()

    def make_engine(self, image: EnvImage, index: int) -> SlotEngine:
        """One replica: container + slot engine over SHARED params.

        One logical checkpoint served N ways: the params tree is
        materialized once per image generation and shared by every replica
        (engines never mutate it), and the compiled steps come warm out of
        the shared CompileCache after the first replica."""
        c = self.runtime.run(image, platform=self.platform, mesh=self.mesh)
        params = self._params.get(image.digest)
        if params is None:
            params = self._params[image.digest] = (
                c.init_params(self.seed) if self._given_params is None
                else c.load_params(self._given_params))
        return SlotEngine(c, params, n_slots=self.n_slots,
                          max_len=self.max_len, eos_id=self.eos_id,
                          name=f"{self.pod_id}/r{index}",
                          decode_chunk=self.decode_chunk,
                          paged=self.paged, page_size=self.page_size,
                          n_pages=self.n_pages,
                          prefix_cache=self.prefix_cache,
                          spill_pages=self.spill_pages,
                          metrics=self.metrics, trace=self.trace)

    def drop_params(self, image_digest: str) -> None:
        """Release a retired generation's shared params (deployer calls
        this after the last blue replica of that image is swapped out)."""
        self._params.pop(image_digest, None)

    # -- capacity -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Admissible slot count. Draining/stopped replicas are excluded
        from BOTH capacity and free_slots: during a blue/green rollover a
        draining replica can take no new work, so counting its slots as
        capacity while free_slots reports 0 made `repro ps` overstate
        headroom by a full replica."""
        return sum(e.n_slots for e in self.engines
                   if not (e.draining or e.stopped))

    @property
    def free_slots(self) -> int:
        return sum(len(e.free) for e in self.engines if e.has_free())

    # -- state --------------------------------------------------------------
    def status(self) -> dict:
        return {
            "pod": self.pod_id,
            "ref": self.ref,
            "image": self.image.short_digest,
            "capacity": self.capacity,
            "free_slots": self.free_slots,
            "rejected": self.rejected,
            "shed": self.shed,
            "router": self.router,
            "phase": ("serving" if any(e.active for e in self.engines)
                      else "idle"),
            "pid": os.getpid(),     # lets `ps` tell live fleets from dead
            "replicas": [e.status() for e in self.engines],
            "metrics": self.metrics.snapshot(),
            "trace": self.trace.status(),
        }

    def write_state(self, final: bool = False) -> Path:
        """Persist status; ``final=True`` stamps a terminal phase so ``ps``
        never misreports the pod after OS pid reuse."""
        d = Path(self.runtime.root) / "pods"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{self.pod_id}.json"
        status = self.status()
        if final:
            status["phase"] = "exited"
        # atomic: state refreshes every scheduler tick and a concurrent
        # `repro ps` must never see a half-written file
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(status, indent=2))
        os.replace(tmp, p)
        return p
