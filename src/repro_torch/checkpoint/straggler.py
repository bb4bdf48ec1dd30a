"""Straggler mitigation: per-step timing outlier detection + reactions
(a copy of ``repro.checkpoint.straggler``).

At 1000+ nodes, a single slow host (thermal throttling, failing HBM, noisy
neighbour) gates every synchronous collective. The monitor keeps a robust
running estimate (median + MAD over a sliding window) of step latency and
flags outliers; launch/train.py reacts by:

  * logging + metrics (always);
  * after ``trip_threshold`` consecutive flags: requesting a checkpoint so
    the scheduler can drain/replace the slow host and the job restarts from
    the last step rather than losing work (ties into elastic.py).

The timings are wall-clock per step; on a cluster each host feeds its own
timer and the reduction is a max() over hosts (one line in launch/train.py).
On a card, ``stop()`` must follow a device sync (launch/train.py reads
the step's loss first), or it times the launches, not the step.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    window: int = 32
    mad_factor: float = 5.0      # flag if step > median + factor * MAD
    trip_threshold: int = 3      # consecutive flags before requesting action
    _times: deque = field(default_factory=lambda: deque(maxlen=64))
    _consecutive: int = 0
    flags: int = 0
    trips: int = 0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, step_seconds: float) -> dict:
        """Feed one step latency; returns {flagged, tripped, median, bound}."""
        ts = sorted(self._times)
        flagged = tripped = False
        median = bound = float("nan")
        if len(ts) >= max(8, self.window // 4):
            median = ts[len(ts) // 2]
            mad = sorted(abs(t - median) for t in ts)[len(ts) // 2]
            bound = median + self.mad_factor * max(mad, 0.02 * median, 1e-9)
            if step_seconds > bound:
                flagged = True
                self.flags += 1
                self._consecutive += 1
                if self._consecutive >= self.trip_threshold:
                    tripped = True
                    self.trips += 1
                    self._consecutive = 0
            else:
                self._consecutive = 0
        if not flagged:
            # outliers are excluded from the running window so one bad host
            # cannot poison the estimate it is judged against
            self._times.append(step_seconds)
        return {"flagged": flagged, "tripped": tripped,
                "median": median, "bound": bound, "step_seconds": step_seconds}
