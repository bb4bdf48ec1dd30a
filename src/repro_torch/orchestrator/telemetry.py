"""Serving telemetry helpers shared by the drivers and benchmarks.

One percentile definition for the whole repo: *nearest-rank* (the smallest
sample such that at least ``pct`` percent of the data is <= it). The
serving driver used to index ``sorted(lat)[int(0.99 * n)]``, which is the
MAX for every n <= 100 (floor(0.99 n) = n-1) and biases the even-n median
a rank high -- fig6/fig8 inherited the same expression. serve.py, fig6 and
fig8 all call :func:`nearest_rank` now, so their p50/p99 columns are
comparable by construction.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def nearest_rank(values: Sequence[float] | Iterable[float],
                 pct: float) -> float:
    """Nearest-rank percentile: the ceil(pct/100 * n)-th smallest sample.

    pct outside [0, 100] raises (checked before anything else, so a bad
    caller fails even on an empty run); the rank is floored at 1, so p0
    asks for the first rank, not the -1st. Empty input returns 0 (a
    serving run with no completions has no latency, not an exception).
    """
    if not 0 <= pct <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {pct}")
    vs = sorted(values)
    if not vs:
        return 0
    rank = max(1, math.ceil(pct / 100.0 * len(vs)))
    return vs[rank - 1]


def request_latencies(done: Iterable) -> list[int]:
    """Per-request serving latency in ticks, measured from when the request
    ARRIVED (trace stagger is offered load, not queueing delay), not from
    the bulk submit at tick 0."""
    return [r.done_tick - max(r.arrival, r.submit_tick) for r in done]


def latency_summary(done: Iterable) -> dict:
    """p50/p99 plus the sample count. ``nearest_rank`` returns 0 for empty
    input, indistinguishable from a true 0-tick latency -- renderers check
    ``latency_count`` and print ``-`` when it is 0."""
    lat = request_latencies(done)
    return {
        "latency_count": len(lat),
        "p50_latency_ticks": nearest_rank(lat, 50),
        "p99_latency_ticks": nearest_rank(lat, 99),
    }
