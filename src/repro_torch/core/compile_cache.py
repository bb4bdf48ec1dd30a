"""CompileCache: built serve steps, cached in memory by content key.

The JAX package persists compiled XLA executables (L1) and lowered
StableHLO (L2) so every replica and rerun skips trace+lower+compile. The
port runs eagerly: a "built" step is a Python callable over the model and
the hand-written kernels (which ``repro_torch.kernels._build`` caches on
disk by source hash). What remains worth caching is the built callable
itself, keyed the way the JAX package keys serve steps -- image sections
that determine the computation, step kind with its shapes, device, and
framework version -- so replicas of one image share one step object and
the per-dispatch-class hit/miss accounting keeps its meaning.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class CacheStats:
    hits_l1: int = 0
    hits_l2: int = 0          # no second level in memory; kept for parity
    misses: int = 0
    last_level: str = ""
    last_seconds: float = 0.0


class CompileCache:
    def __init__(self):
        self._entries: dict[str, Any] = {}
        self.stats = CacheStats()

    # -- keying --------------------------------------------------------------
    def key(self, *, image_digest: str, step_kind: str,
            device: torch.device | str) -> str:
        body = json.dumps(
            {
                "image": image_digest,
                "step": step_kind,
                "device": str(device),
                "torch": torch.__version__,
            },
            sort_keys=True,
        )
        return hashlib.sha256(body.encode()).hexdigest()

    # -- main entry ------------------------------------------------------------
    def get_or_build(self, key: str, build_fn: Callable[[], Any]):
        """The cached step for ``key``, built by ``build_fn()`` on a miss."""
        t0 = time.perf_counter()
        hit = self._entries.get(key)
        if hit is not None:
            self.stats.hits_l1 += 1
            self.stats.last_level = "L1"
            self.stats.last_seconds = time.perf_counter() - t0
            return hit
        built = build_fn()
        self._entries[key] = built
        self.stats.misses += 1
        self.stats.last_level = "L0"
        self.stats.last_seconds = time.perf_counter() - t0
        return built

    def has(self, key: str) -> bool:
        return key in self._entries

    def evict(self, key: str) -> None:
        self._entries.pop(key, None)
