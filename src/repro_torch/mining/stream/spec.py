"""StreamSpec: the streaming-ingestion knobs, one frozen config object.

Mirrors ``MineSpec``'s posture (hashable, ``with_``-less — streams are
long-lived, the spec is fixed at stream creation): how new batches are
padded into segments, and when the LSM-style compactor folds small
segments back together.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """How a ``StreamingMiner`` segments and compacts its database.

    ``row_pad`` pads every appended batch's row count up to a multiple
    (padding rows are all-PAD, support-neutral), so repeated appends of
    uneven sizes give their segments the same row count.

    Compaction (LSM-style): a pass merges the ``compact_fanin`` smallest
    segments' host rows and re-prepares them as one segment. It triggers
    when the segment count exceeds ``max_segments``, or when segments
    smaller than ``small_rows`` rows together hold more than
    ``small_byte_frac`` of the database's bytes (``small_rows=0`` disables
    the byte-fraction trigger). ``compact_async=True`` runs the merge
    re-prepare on a background thread (on CUDA, on a stream of its own) so
    it stays off the append/query path; queries meanwhile serve from the
    uncompacted segments — bit-for-bit the same answers, supports being
    additive either way.

    Continuous-mode knobs (``repro_torch.mining.continuous``):

    ``window_rows`` / ``window_batches`` arm a sliding window: at append
    time the oldest segments are expired (``SegmentedDB.drop_segments``)
    until the retained suffix is the *minimal* one still covering at
    least that many real rows / appended batches. Expiry is exact —
    supports are additive per segment, so a drop subtracts the segment's
    counts and F2 block bit-for-bit. With a window armed, compaction only
    merges append-order-contiguous runs, so expiry stays segment-granular.

    ``decay < 1`` arms time-decayed supports: at query time segment
    supports are weighted by ``decay ** (appends since the segment
    arrived)`` and accumulated in float64 next to the exact integer path
    (threshold applied post-reduce). Decay requires per-segment ages, so
    it disables compaction (a merged segment has no single age) — the
    byte-fraction trigger must be left off.

    ``min_sup_floor > 0`` is the loosest ``min_sup`` the stream answers
    (its *floor*). An item is admitted while its count over the retained
    rows reaches ``ceil(min_sup_floor · rows)``; segments are prepared
    with their batch's admitted items only, and the global F2 matrix
    covers the admitted items, not the item universe, so a stream over a
    wide universe (a click stream) holds a few hundred ranks, not tens of
    thousands. Answers stay exact: a segment whose rows hold an item
    admitted after it was built is prepared again before the next query.
    A query below the floor raises. Decayed supports take no floor. The
    default 0 admits every item at its first appearance.
    """

    row_pad: int = 1  # pad each batch's rows to a multiple of this
    max_segments: int = 16  # compaction trigger: segment count
    small_rows: int = 0  # a segment under this many rows is "small"
    small_byte_frac: float = 0.5  # trigger: small segments' byte fraction
    compact_fanin: int = 4  # smallest segments merged per compaction pass
    compact_async: bool = False  # merge re-prepare on a background thread
    window_rows: int = 0  # sliding window over real rows (0 = unbounded)
    window_batches: int = 0  # sliding window over appended batches
    decay: float = 1.0  # per-append damping of older segments' supports
    min_sup_floor: float = 0.0  # loosest min_sup answered; admits items (0 = all)

    def __post_init__(self):
        if self.row_pad < 1:
            raise ValueError(f"row_pad must be >= 1, got {self.row_pad}")
        if self.max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {self.max_segments}")
        if self.compact_fanin < 2:
            raise ValueError(f"compact_fanin must be >= 2, got {self.compact_fanin}")
        if self.compact_fanin > self.max_segments:
            # contradictory: the count trigger fires at > max_segments, but
            # a pass would want to merge more segments than the trigger
            # guarantees exist — the stream would thrash or never converge
            raise ValueError(
                f"compact_fanin={self.compact_fanin} exceeds "
                f"max_segments={self.max_segments}; a compaction pass cannot "
                "merge more segments than the trigger guarantees live"
            )
        if not (0.0 < self.small_byte_frac <= 1.0):
            raise ValueError(
                f"small_byte_frac must be in (0, 1], got {self.small_byte_frac}"
            )
        if self.small_rows < 0:
            raise ValueError(f"small_rows must be >= 0, got {self.small_rows}")
        if self.window_rows < 0:
            raise ValueError(f"window_rows must be >= 0, got {self.window_rows}")
        if self.window_batches < 0:
            raise ValueError(
                f"window_batches must be >= 0, got {self.window_batches}"
            )
        if self.window_rows and self.window_batches:
            raise ValueError(
                "window_rows and window_batches are alternative window units; "
                "set at most one"
            )
        if not (0.0 < self.decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.decay < 1.0 and self.small_rows > 0:
            raise ValueError(
                "decay < 1 disables compaction (a merged segment has no "
                "single age) but small_rows > 0 arms the byte-fraction "
                "compaction trigger — remove one"
            )
        if not (0.0 <= self.min_sup_floor < 1.0):
            raise ValueError(
                f"min_sup_floor must be in [0, 1), got {self.min_sup_floor}"
            )
        if self.min_sup_floor > 0 and self.decay < 1.0:
            raise ValueError(
                "min_sup_floor > 0 needs exact integer supports; decayed "
                "streams (decay < 1) take no floor"
            )

    @property
    def windowed(self) -> bool:
        """True when a sliding window (rows or batches) is armed."""
        return bool(self.window_rows or self.window_batches)
