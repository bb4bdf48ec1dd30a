"""Pod orchestrator (PyTorch port): continuous-batching serving over
Containers -- ``Pod``, ``SlotEngine``, ``ContinuousScheduler``, the
``PagePool`` with its radix prefix registry, and the request queue.

``Pod(..., paged=True)`` swaps the contiguous per-slot KV slabs for a
global page pool served by the paged-attention kernel;
``prefix_cache=True`` adds copy-on-write prefix page sharing on top.

``PodRouter`` fronts N pods (shortest-queue, consistent-hash or
prefix-hash placement, spillover before reject, drains) and
``RollingDeployer`` rolls a pod or a router fleet onto a re-pointed tag.
The cross-host fabric comes with a later slice (ROADMAP.md Queue 1 item 8).
"""

from repro_torch.orchestrator.deployer import RollingDeployer
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
    "latency_summary",
    "nearest_rank",
]
