"""MineResult: the one enriched answer every miner returns.

Supersedes the seed's per-algorithm surfaces (core ``MineResult`` without
timings, ``(dict, stats)`` tuples from fpgrowth/apriori, bare dict from the
oracle): itemsets + exact count + memory peak + wall time + per-stage
timings, whichever backend produced them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MineResult:
    """Frequent itemsets (original item ids) plus run telemetry.

    ``itemsets`` maps sorted item-id tuples to supports. ``total_count`` is
    the exact number of frequent itemsets — for CPE-pruned miners it exceeds
    ``n_explicit`` (``itemsets`` then holds the explicit subset only, each
    with its exact support). When ``spec.patterns != "all"``, ``itemsets``
    holds the selected family and ``n_explicit``/``total_count`` still
    describe the full frequent collection it was derived from.
    """

    algorithm: str
    itemsets: dict[tuple[int, ...], int]
    total_count: int  # exact number of frequent itemsets (incl. CPE-implied)
    n_explicit: int  # itemsets explicitly materialized by the miner
    min_count: int  # resolved absolute threshold used
    n_rows: int  # database size the threshold was resolved against
    peak_bytes: int  # analytic peak of mining structures (paper's memory figs)
    wall_time_s: float  # host-observed end-to-end mining time
    stage_times_s: dict[str, float] = dataclasses.field(default_factory=dict)
    flist_items: np.ndarray | None = None  # F1 items, support-descending
    # True when prep stages (Job 1/Job 2/pack/F2) were served from a shared
    # PreparedDB built for another request in the same planned group; the
    # request that paid for prep carries the real stage times, shared
    # consumers carry 0.0 for those keys (honest attribution, no double
    # counting when summing stage times across a sweep).
    prep_shared: bool = False
    # Serving-layer telemetry, filled by whoever routed the request:
    #   prep_source      "built" | "cache" | "snapshot" (engine)
    #   prep_overlapped  True when this group's prepare ran while an earlier
    #                    group was still mining (scheduler)
    #   queue_time_s     submit -> batch-execution-start (service)
    #   batch_size       requests coalesced into this request's batch (service)
    service_stats: dict = dataclasses.field(default_factory=dict)

    def support_of(self, itemset) -> int:
        return self.itemsets[tuple(sorted(int(i) for i in itemset))]

    def by_size(self, k: int) -> dict[tuple[int, ...], int]:
        """The mined itemsets of exactly ``k`` items."""
        return {s: v for s, v in self.itemsets.items() if len(s) == k}

    def top(self, n: int = 10) -> list[tuple[tuple[int, ...], int]]:
        """Largest-then-most-supported itemsets (the CLI's report order)."""
        return sorted(self.itemsets.items(), key=lambda kv: (-len(kv[0]), -kv[1]))[:n]

    def summary(self) -> str:
        return (
            f"{self.algorithm}: {self.total_count} frequent itemsets "
            f"({self.n_explicit} explicit) at min_count={self.min_count} "
            f"over {self.n_rows} rows in {self.wall_time_s:.3f}s "
            f"[peak {self.peak_bytes / 1e6:.2f} MB]"
        )
