"""Shared metrics registry: counters, gauges, fixed-bucket histograms.

One registry per pod replaces the hand-rolled counter attributes that were
scattered across ``SlotEngine``, ``ContinuousScheduler``, ``PagePool`` and
``PodRouter``: every accounting site increments a named, optionally
labelled metric, and ``repro ps`` / ``repro top`` / the fig benchmarks
read one snapshot instead of re-deriving numbers from five ad-hoc places.
The old attribute names survive as read-only property shims so no caller
changed shape.

Everything here is tick-clocked and deterministic: metrics carry no
wall-clock state, so the same request trace produces the bitwise-same
snapshot (the property the span-log recompute check in ``obs.report``
pins). Wall-time accounting (``prefill_s``/``decode_s``) deliberately
stays OUTSIDE the registry, on the engines, for exactly that reason.

``Histogram`` is a fixed-bucket streaming histogram whose ``percentile``
is *nearest-rank by construction*: samples are floored to their bucket's
lower bound, so the reported percentile is ``floor(s / width) * width``
of the true nearest-rank sample ``s`` -- identical to
``telemetry.nearest_rank`` for ``width == 1`` on integer samples (the
tick-valued latency histograms), and within one bucket width otherwise.
"""

from __future__ import annotations

import math


class Counter:
    """Monotone non-negative integer count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += int(n)


class Gauge:
    """Point-in-time value plus its high-water mark."""

    __slots__ = ("value", "high")

    def __init__(self):
        self.value = 0
        self.high = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.high:
            self.high = v


class Histogram:
    """Fixed-bucket streaming histogram over non-negative samples.

    Bucket ``i`` covers ``[i * width, (i + 1) * width)``; samples at or
    past the last bucket clamp into it (so extreme percentiles degrade to
    a lower bound instead of growing memory). ``percentile`` applies the
    repo-wide nearest-rank definition to the bucket counts and returns the
    rank-th sample's bucket lower bound.

    Buckets optionally carry an *exemplar*: a representative request id
    recorded alongside a sample, so a percentile read links back to a
    concrete trace (``repro top`` shows the rid behind the p99).
    Exemplars combine by minimum, which makes them independent of record
    and merge order -- the live registry and the span-log recompute stay
    bitwise-identical.
    """

    __slots__ = ("width", "n_buckets", "counts", "count", "sum",
                 "exemplars")

    def __init__(self, width: int = 1, n_buckets: int = 512):
        if width < 1 or n_buckets < 1:
            raise ValueError("histogram needs width >= 1 and n_buckets >= 1")
        self.width = int(width)
        self.n_buckets = int(n_buckets)
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.sum = 0
        self.exemplars: dict[int, int] = {}

    def record(self, v, *, exemplar: int | None = None) -> None:
        v = int(v)
        if v < 0:
            raise ValueError(f"histogram sample must be >= 0, got {v}")
        idx = min(v // self.width, self.n_buckets - 1)
        self.counts[idx] += 1
        self.count += 1
        self.sum += v
        if exemplar is not None:
            exemplar = int(exemplar)
            cur = self.exemplars.get(idx)
            if cur is None or exemplar < cur:
                self.exemplars[idx] = exemplar

    def percentile(self, pct: float):
        """Nearest-rank percentile at bucket resolution; 0 for no samples
        (callers that must distinguish check ``count`` -- see the
        ``latency_count`` convention in telemetry/ps)."""
        if not 0 <= pct <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {pct}")
        if self.count == 0:
            return 0
        rank = max(1, math.ceil(pct / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return i * self.width
        return (self.n_buckets - 1) * self.width     # pragma: no cover

    def merge(self, other: "Histogram") -> None:
        if (other.width, other.n_buckets) != (self.width, self.n_buckets):
            raise ValueError(
                f"cannot merge histograms of geometry "
                f"({other.width}, {other.n_buckets}) into "
                f"({self.width}, {self.n_buckets})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for i, e in other.exemplars.items():
            cur = self.exemplars.get(i)
            if cur is None or e < cur:
                self.exemplars[i] = e

    def exemplar_at(self, pct: float) -> int | None:
        """The exemplar rid of the bucket that ``percentile(pct)`` lands
        in; None when the histogram is empty or the bucket never saw an
        exemplar-carrying sample."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(pct / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.exemplars.get(i)
        return None                                  # pragma: no cover

    def snapshot(self) -> dict:
        # sparse counts: state files refresh every few ticks, and a dense
        # 4096-zero vector per histogram per pod would dominate them
        return {
            "width": self.width,
            "n_buckets": self.n_buckets,
            "count": self.count,
            "sum": self.sum,
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
            "exemplars": {str(i): e
                          for i, e in sorted(self.exemplars.items())},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(width=snap["width"], n_buckets=snap["n_buckets"])
        for i, c in snap["counts"].items():
            h.counts[int(i)] = int(c)
        h.count = int(snap["count"])
        h.sum = int(snap["sum"])
        # absent in pre-exemplar snapshots; default keeps them loadable
        h.exemplars = {int(i): int(e)
                       for i, e in snap.get("exemplars", {}).items()}
        return h


def _label_key(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class MetricsRegistry:
    """Named metrics with optional labels, get-or-create semantics.

    ``counter("tokens_generated", replica="pod-x/r0")`` returns the same
    object on every call, so hot paths bind the metric once at init and
    increment a plain attribute. ``snapshot()`` is a deterministic nested
    dict (sorted keys) suitable for the pod state files; registries
    aggregate with :func:`merge_snapshots` (the router's fleet view).
    """

    def __init__(self):
        self._counters: dict[str, dict[str, Counter]] = {}
        self._gauges: dict[str, dict[str, Gauge]] = {}
        self._histograms: dict[str, dict[str, Histogram]] = {}

    # -- get-or-create -------------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(name, {}).setdefault(
            _label_key(labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self._gauges.setdefault(name, {}).setdefault(
            _label_key(labels), Gauge())

    def histogram(self, name: str, *, width: int = 1, n_buckets: int = 512,
                  **labels) -> Histogram:
        h = self._histograms.setdefault(name, {}).setdefault(
            _label_key(labels), Histogram(width=width, n_buckets=n_buckets))
        if (h.width, h.n_buckets) != (width, n_buckets):
            raise ValueError(
                f"histogram {name!r} already registered with geometry "
                f"({h.width}, {h.n_buckets}), requested ({width}, "
                f"{n_buckets})")
        return h

    # -- reads ---------------------------------------------------------------
    def total(self, name: str) -> int:
        """Counter/gauge value summed across labels (0 if unregistered)."""
        series = self._counters.get(name) or self._gauges.get(name) or {}
        return sum(m.value for m in series.values())

    def merged_histogram(self, name: str) -> Histogram | None:
        series = self._histograms.get(name)
        if not series:
            return None
        out = None
        for h in series.values():
            if out is None:
                out = Histogram(width=h.width, n_buckets=h.n_buckets)
            out.merge(h)
        return out

    def percentile(self, name: str, pct: float):
        h = self.merged_histogram(name)
        return h.percentile(pct) if h else 0

    # -- snapshots -----------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "counters": {
                name: {lk: c.value for lk, c in sorted(series.items())}
                for name, series in sorted(self._counters.items())},
            "gauges": {
                name: {lk: {"value": g.value, "high": g.high}
                       for lk, g in sorted(series.items())}
                for name, series in sorted(self._gauges.items())},
            "histograms": {
                name: {lk: h.snapshot() for lk, h in sorted(series.items())}
                for name, series in sorted(self._histograms.items())},
        }


def merge_snapshots(snaps: list[dict]) -> dict:
    """Aggregate registry snapshots (the router's fleet rollup): counters
    and gauge values sum across sources, gauge highs sum too (per-pod
    peaks are independent, so the fleet high-water is their sum as an
    upper bound), histograms add bucket-wise. Labels are preserved, so a
    per-replica breakdown survives aggregation."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for name, series in snap.get("counters", {}).items():
            dst = out["counters"].setdefault(name, {})
            for lk, v in series.items():
                dst[lk] = dst.get(lk, 0) + v
        for name, series in snap.get("gauges", {}).items():
            dst = out["gauges"].setdefault(name, {})
            for lk, g in series.items():
                cur = dst.setdefault(lk, {"value": 0, "high": 0})
                cur["value"] += g["value"]
                cur["high"] += g["high"]
        for name, series in snap.get("histograms", {}).items():
            dst = out["histograms"].setdefault(name, {})
            for lk, hs in series.items():
                if lk not in dst:
                    dst[lk] = Histogram.from_snapshot(hs).snapshot()
                else:
                    h = Histogram.from_snapshot(dst[lk])
                    h.merge(Histogram.from_snapshot(hs))
                    dst[lk] = h.snapshot()
    return out


def snapshot_percentile(snap: dict, name: str, pct: float):
    """Nearest-rank percentile over a snapshot's histogram ``name``,
    merged across labels. Returns None when the histogram is absent or
    empty -- renderers print ``-`` instead of a fake 0-tick latency."""
    series = snap.get("histograms", {}).get(name)
    if not series:
        return None
    merged = None
    for hs in series.values():
        h = Histogram.from_snapshot(hs)
        if merged is None:
            merged = Histogram(width=h.width, n_buckets=h.n_buckets)
        merged.merge(h)
    if merged is None or merged.count == 0:
        return None
    return merged.percentile(pct)


def snapshot_exemplar(snap: dict, name: str, pct: float) -> int | None:
    """Representative rid behind ``snapshot_percentile(snap, name, pct)``:
    merges the histogram across labels and returns the exemplar of the
    nearest-rank bucket (None when absent)."""
    series = snap.get("histograms", {}).get(name)
    if not series:
        return None
    merged = None
    for hs in series.values():
        h = Histogram.from_snapshot(hs)
        if merged is None:
            merged = Histogram(width=h.width, n_buckets=h.n_buckets)
        merged.merge(h)
    if merged is None or merged.count == 0:
        return None
    return merged.exemplar_at(pct)


def snapshot_count(snap: dict, name: str) -> int:
    series = snap.get("histograms", {}).get(name) or {}
    return sum(hs.get("count", 0) for hs in series.values())


def snapshot_total(snap: dict, name: str) -> int:
    """Counter (or gauge value) total across labels from a snapshot."""
    series = snap.get("counters", {}).get(name)
    if series is not None:
        return sum(series.values())
    gauges = snap.get("gauges", {}).get(name) or {}
    return sum(g.get("value", 0) for g in gauges.values())
