"""Pod orchestrator (PyTorch port): continuous-batching serving over
Containers -- ``Pod``, ``SlotEngine``, ``ContinuousScheduler``, the
``PagePool`` with its radix prefix registry, and the request queue.

``Pod(..., paged=True)`` swaps the contiguous per-slot KV slabs for a
global page pool served by the paged-attention kernel;
``prefix_cache=True`` adds copy-on-write prefix page sharing on top.

``PodRouter`` fronts N pods (shortest-queue, consistent-hash or
prefix-hash placement, spillover before reject, drains) and
``RollingDeployer`` rolls a pod or a router fleet onto a re-pointed tag.

``FabricRouter`` (``repro_torch.orchestrator.fabric``) takes the router
cross-host: pods become workers behind a framed message transport
(in-process loopback or one OS process per pod), with heartbeat liveness,
dead-pod eviction + exactly-once re-routing of in-flight work, and an
elastic spawn/drain/retire fleet.
"""

from repro_torch.orchestrator.deployer import RollingDeployer
from repro_torch.orchestrator.fabric import (FABRIC_POLICIES, FabricRouter,
                                             PodWorker, decode_request,
                                             encode_request, load_fleet_spans,
                                             loopback_spawner, proc_spawner)
from repro_torch.orchestrator.page_pool import PagePool
from repro_torch.orchestrator.pod import Pod
from repro_torch.orchestrator.request_queue import (PRIORITIES, GenRequest,
                                                    RequestQueue)
from repro_torch.orchestrator.router import PLACEMENT_POLICIES, PodRouter
from repro_torch.orchestrator.scheduler import ContinuousScheduler, SlotEngine
from repro_torch.orchestrator.telemetry import latency_summary, nearest_rank

__all__ = [
    "GenRequest",
    "PRIORITIES",
    "RequestQueue",
    "PagePool",
    "Pod",
    "PodRouter",
    "PLACEMENT_POLICIES",
    "SlotEngine",
    "ContinuousScheduler",
    "RollingDeployer",
    "FABRIC_POLICIES",
    "FabricRouter",
    "PodWorker",
    "encode_request",
    "decode_request",
    "load_fleet_spans",
    "loopback_spawner",
    "proc_spawner",
    "latency_summary",
    "nearest_rank",
]
