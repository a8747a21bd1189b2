"""MineSpec: the one typed request object every miner accepts.

A spec is frozen and hashable, so engines can key warm miner instances
on it, and benchmarks can sweep thresholds by ``dataclasses.replace``.
Threshold is given *either* as a support fraction (``min_sup``, the paper's
x-axis) or an absolute count (``min_count``); ``resolve(n_rows)`` is the
single place the fraction-to-count conversion lives.
"""
from __future__ import annotations

import dataclasses
import math

PATTERN_KINDS = ("all", "closed", "maximal", "top_rank_k")


@dataclasses.dataclass(frozen=True)
class MineSpec:
    """What to mine, independent of which backend executes it.

    ``algorithm`` names a registered miner (see ``repro.mining.list_miners``).
    ``patterns`` selects a post-pass over the frequent-itemset dict:
    ``all`` (raw), ``closed`` / ``maximal`` / ``top_rank_k`` (the NAFCP /
    MFI / NTK result surfaces from the paper's lineage); ``rank_k`` is the
    k of ``top_rank_k``. The candidate/width knobs only matter to the
    distributed hprepost backend; host miners ignore them.
    """

    algorithm: str = "hprepost"
    min_sup: float | None = None  # support threshold as a fraction of rows
    min_count: int | None = None  # ... or as an absolute transaction count
    max_k: int | None = None  # cap on itemset size (None = unbounded)
    patterns: str = "all"
    rank_k: int = 10
    backend: str = "auto"  # a repro_torch.mining.tune registry name; validated in
    # resolve() against registered_backends()
    candidate_unit: int = 256  # hprepost: candidate buffers, pow2 multiples
    nlist_width: int | None = None  # hprepost: static N-list width (None = auto)
    la_block: int = 512  # hprepost: A-codes per early-stop liveness tile
    partition_candidates: bool = True  # hprepost mode B (PFP groups)
    max_f1: int = 4096  # guard on |F-list|
    max_itemsets: int = 2_000_000
    early_stop: bool = True  # hprepost: early-stopping intersections (host
    # Apriori-closure pruning + in-kernel bound masking where sound); False
    # runs the exact legacy path bit-for-bit
    tune: bool = False  # hprepost: resolve la_block via the persisted
    # KernelTuner instead of the static field
    # Service-level QoS, ignored by direct mine() calls: neither field
    # participates in device config / prep keys (execution-orthogonal).
    priority: int = 0  # MiningService: higher priority groups serve first
    deadline_s: float | None = None  # MiningService: drop (DeadlineExceeded)
    # if not *started* within this many seconds of submit

    def __post_init__(self):
        if self.min_sup is not None and self.min_count is not None:
            raise ValueError("MineSpec takes min_sup or min_count, not both")
        if self.min_sup is not None and not (0.0 < self.min_sup <= 1.0):
            raise ValueError(f"min_sup must be in (0, 1], got {self.min_sup}")
        if self.min_count is not None and self.min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {self.min_count}")
        if self.patterns not in PATTERN_KINDS:
            raise ValueError(f"patterns must be one of {PATTERN_KINDS}, got {self.patterns!r}")
        if self.max_k is not None and self.max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {self.max_k}")
        if self.rank_k < 1:
            raise ValueError(f"rank_k must be >= 1, got {self.rank_k}")
        if self.la_block < 1:
            raise ValueError(f"la_block must be >= 1, got {self.la_block}")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")

    def resolve(self, n_rows: int) -> int:
        """Absolute support threshold for a database of ``n_rows`` rows.

        Ceiling semantics: an itemset is frequent iff ``support / n_rows >=
        min_sup``, i.e. ``support >= ceil(min_sup * n_rows)``. Flooring here
        would admit itemsets *below* the requested fraction (min_sup=0.25
        over 10 rows must demand count 3, not 2). The 1e-9 slack keeps exact
        fractions exact under float noise (``3/7 * 7`` is 3.0000000000000004
        and must resolve to 3, not 4).

        Also the choke point every execution path funnels through before
        any device work, so the backend name is validated here: unknown
        names fail with the registered list instead of silently running
        whatever the old string switch fell through to."""
        from repro_torch.mining.tune import registered_backends

        if self.backend not in registered_backends():
            raise ValueError(
                f"unknown backend {self.backend!r}; registered backends: "
                f"{', '.join(registered_backends())}"
            )
        if self.min_count is not None:
            return int(self.min_count)
        if self.min_sup is None:
            raise ValueError("MineSpec needs min_sup or min_count to mine")
        return max(1, math.ceil(self.min_sup * n_rows - 1e-9))

    def with_(self, **changes) -> "MineSpec":
        """``dataclasses.replace`` that also lets a min_sup spec switch to
        min_count (and vice versa) without tripping the both-set check.

        Explicitly passing ``min_sup=None`` (or ``min_count=None``) does not
        silently clear the other kind; a change that would leave a
        previously-resolvable spec with no threshold at all raises here, at
        construction, instead of deep inside ``mine()``."""
        if changes.get("min_sup") is not None and "min_count" not in changes:
            changes["min_count"] = None
        if changes.get("min_count") is not None and "min_sup" not in changes:
            changes["min_sup"] = None
        new = dataclasses.replace(self, **changes)
        had_threshold = self.min_sup is not None or self.min_count is not None
        if had_threshold and new.min_sup is None and new.min_count is None:
            raise ValueError(
                "with_() cleared the support threshold (min_sup and min_count "
                "are both None now); set the other threshold kind in the same "
                "call, e.g. with_(min_sup=None, min_count=3)"
            )
        return new
