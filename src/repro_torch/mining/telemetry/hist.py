"""Fixed log-bucket latency histograms plus a counter/gauge registry.

``LatencyHistogram`` is the workhorse: a fixed set of log-spaced bucket
upper edges (shared by every instance created with the default layout, so
histograms merge without resampling), exact ``count``/``sum``/``min``/
``max`` under a lock, and quantile *estimates* located from the bucket
boundaries. The estimate contract — what the property tests pin down — is

  - counts are exact (every ``record`` lands in exactly one bucket);
  - ``merge`` is associative and commutative and loses nothing: the
    merged histogram is bucket-for-bucket the sum of its inputs;
  - a quantile estimate is bounded by the edges of the bucket that
    contains the true quantile (and by the observed min/max, which can
    only tighten that interval — both always contain the true value).

Everything here is plain Python + ``threading.Lock``: instruments are
touched from the service worker loop, the scheduler prep pool, stream
append paths and RPC collect loops concurrently. Recording is O(log
buckets) (a bisect) under a per-instrument lock — nanoseconds against
the microsecond-scale latencies being measured, and execution-orthogonal
by construction: nothing here ever feeds a prep/device/snapshot key.

``Registry`` is the shared namespace: get-or-create by dotted name
(``admission.queue_wait_s``, ``engine.stage.mining_waves_s``,
``dist.<stream>.worker<wid>.wave_rpc_s``, ...), one ``snapshot()`` that
the stats surface and the periodic emitter both consume. The snapshot
dict carries ``SCHEMA_VERSION`` so JSON-lines consumers can detect
layout changes.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left

# Version of the snapshot/emitter JSON layout. Bump when bucket edges,
# snapshot keys, or the emitter envelope change shape.
SCHEMA_VERSION = 1

# Default bucket upper edges (seconds): log-spaced, factor 2, from 1us up
# to ~9 minutes; values above the last edge land in a +Inf overflow
# bucket. 30 edges -> 31 buckets, small enough to snapshot densely.
_N_EDGES = 30
DEFAULT_EDGES = tuple(1e-6 * (2.0 ** i) for i in range(_N_EDGES))


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram over non-negative seconds."""

    __slots__ = ("edges", "counts", "n", "total", "vmin", "vmax", "_lock")

    def __init__(self, edges=DEFAULT_EDGES):
        self.edges = tuple(edges)
        if not self.edges or any(
            b <= a for a, b in zip(self.edges, self.edges[1:])
        ):
            raise ValueError("edges must be non-empty and strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)  # last = overflow (+Inf)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    # ------------------------------------------------------------ record
    def record(self, seconds: float) -> None:
        """Record one latency observation (negative clamps to 0)."""
        v = float(seconds)
        if v < 0.0 or v != v:  # clamp negatives, drop NaN to 0
            v = 0.0
        i = bisect_left(self.edges, v)  # first edge >= v; len(edges) = +Inf
        with self._lock:
            self.counts[i] += 1
            self.n += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    # ------------------------------------------------------------- merge
    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (exact: bucket-wise sum). Returns self."""
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        # lock ordering by id() so concurrent cross-merges cannot deadlock
        first, second = (self, other) if id(self) < id(other) else (other, self)
        with first._lock, second._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.n += other.n
            self.total += other.total
            if other.vmin < self.vmin:
                self.vmin = other.vmin
            if other.vmax > self.vmax:
                self.vmax = other.vmax
        return self

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram(self.edges)
        with self._lock:
            h.counts = list(self.counts)
            h.n = self.n
            h.total = self.total
            h.vmin = self.vmin
            h.vmax = self.vmax
        return h

    # --------------------------------------------------------- quantiles
    def _bucket_bounds(self, i: int) -> tuple[float, float]:
        lo = 0.0 if i == 0 else self.edges[i - 1]
        hi = self.edges[i] if i < len(self.edges) else math.inf
        return lo, hi

    def quantile_bounds(self, q: float) -> tuple[float, float]:
        """Edges of the bucket containing the true q-quantile (the k-th
        smallest observation, k = ceil(q*n) clamped to [1, n])."""
        with self._lock:
            if self.n == 0:
                return (0.0, 0.0)
            k = min(self.n, max(1, math.ceil(q * self.n)))
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= k:
                    return self._bucket_bounds(i)
        return self._bucket_bounds(len(self.edges))  # unreachable

    def quantile(self, q: float) -> float:
        """Point estimate for the q-quantile: geometric midpoint of the
        containing bucket, tightened by the observed min/max. Always lies
        within ``quantile_bounds(q)``."""
        with self._lock:
            if self.n == 0:
                return 0.0
            k = min(self.n, max(1, math.ceil(q * self.n)))
            cum = 0
            idx = len(self.edges)
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= k:
                    idx = i
                    break
            lo, hi = self._bucket_bounds(idx)
            if not math.isfinite(hi):
                hi = max(self.vmax, lo)  # overflow bucket: cap at observed max
            est = math.sqrt(lo * hi) if lo > 0.0 else hi / 2.0
            # clamp into the bucket, then tighten by observed extremes —
            # the true quantile lies in both intervals, so their
            # intersection is non-empty and still inside the bucket
            est = min(max(est, lo), hi)
            est = min(max(est, self.vmin), self.vmax)
            return min(max(est, lo), hi)

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON-ready summary. Bucket counts are exported sparsely keyed
        by upper edge ("inf" for the overflow bucket)."""
        with self._lock:
            n, total = self.n, self.total
            vmin = self.vmin if n else 0.0
            vmax = self.vmax if n else 0.0
            buckets = {
                ("inf" if i == len(self.edges) else repr(self.edges[i])): c
                for i, c in enumerate(self.counts)
                if c
            }
        return {
            "count": n,
            "sum_s": total,
            "min_s": vmin,
            "max_s": vmax,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
            "buckets": buckets,
        }


class Counter:
    """Monotone counter (thread-safe)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Point-in-time value (thread-safe set/add)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def add(self, dv: float) -> None:
        with self._lock:
            self._v += dv

    @property
    def value(self) -> float:
        return self._v


class Registry:
    """Get-or-create namespace of instruments, snapshotted as one dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, LatencyHistogram] = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            return h

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histograms(self) -> dict:
        """name -> histogram snapshot, sorted by name."""
        with self._lock:
            items = sorted(self._hists.items())
        return {name: h.snapshot() for name, h in items}

    def snapshot(self) -> dict:
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
        return {
            "schema": SCHEMA_VERSION,
            "histograms": self.histograms(),
            "counters": {n: c.value for n, c in counters},
            "gauges": {n: g.value for n, g in gauges},
        }
