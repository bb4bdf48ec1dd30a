"""Pod orchestrator (PyTorch port): continuous-batching serving over
Containers -- ``Pod``, ``SlotEngine``, ``ContinuousScheduler``, the
``PagePool`` with its radix prefix registry, and the request queue.

``Pod(..., paged=True)`` swaps the contiguous per-slot KV slabs for a
global page pool served by the paged-attention kernel;
``prefix_cache=True`` adds copy-on-write prefix page sharing on top.

The router, deployer and cross-host fabric come with a later slice
(ROADMAP.md Queue 1 item 8).
"""

from repro_torch.orchestrator.page_pool import PagePool
from repro_torch.orchestrator.pod import Pod
from repro_torch.orchestrator.request_queue import (PRIORITIES, GenRequest,
                                                    RequestQueue)
from repro_torch.orchestrator.scheduler import ContinuousScheduler, SlotEngine
from repro_torch.orchestrator.telemetry import latency_summary, nearest_rank

__all__ = [
    "GenRequest",
    "PRIORITIES",
    "RequestQueue",
    "PagePool",
    "Pod",
    "SlotEngine",
    "ContinuousScheduler",
    "latency_summary",
    "nearest_rank",
]
