"""SegmentedDB: an ordered collection of per-batch prepared segments plus
the merged global aggregates the reduce step needs.

The paper's MapReduce observation, kept live instead of re-derived: PPC
trees / N-lists built over *disjoint* transaction partitions are
independent map outputs, and per-itemset supports are additive in the
reduce. A ``SegmentedDB`` therefore holds

  - one ``Segment`` per appended batch (its host rows for later
    compaction, its ``PreparedDB``, and its sentinel-extended N-list planes
    on the device, ready for cross-segment waves),
  - the **stream item order**: an append-only map item -> global rank,
    assigned at first appearance. Every segment's PPC tree is built in
    this shared order (``HPrepostMiner.prepare(flist=...)``), which is
    what makes cross-segment N-list intersections exact — ancestor
    relations agree across all segments, and a segment's local rank space
    is an order-preserving subset of the global one,
  - the merged global item counts (summed per-batch histograms — the
    streaming Job 1 reduce) and the merged F2 co-occurrence matrix in
    stream-rank space (summed per-segment ``PreparedDB.C``, embedded
    monotonically — the streaming F2 reduce).

Pure data structure: no device work and no locking here — the
``StreamingMiner`` orchestrates both.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from repro_torch.core import encoding as enc
from repro_torch.core.hprepost import PreparedDB, SegmentHandle


@dataclasses.dataclass
class Segment:
    """One appended batch, prepared and device-resident.

    ``shard_planes`` is the only device copy of the segment's N-lists: per
    data shard of the miner's mesh, the ``(3, K_s + 1, W_s)`` int32 planes
    the wave kernel reads, sentinel row at ``K_s``
    (``HPrepostMiner.extend_with_sentinel``). Each of ``prepared.packed`` is
    a ``(K_s, W_s, 3)`` view of the same memory (what ``to_host`` gathers),
    not a second buffer. (The reference keeps a ``(D, K_s, W_s, 3)`` buffer
    and a sentinel-extended copy of it.)"""

    seg_id: int
    rows: np.ndarray  # host copy, row-padded (all-PAD pad rows)
    n_rows: int  # real (pre-padding) transaction count
    prepared: PreparedDB
    shard_planes: tuple  # per data shard: device (3, K_s + 1, W_s) int32, sentinel row appended
    local_items: np.ndarray  # items in this segment's tree, stream order
    item_to_local: np.ndarray  # (n_items,) int32: item -> local rank | -1
    digest: str  # content digest of ``rows`` (snapshot identity)
    n_batches: int = 1  # appended batches folded in (compaction merges sum)
    tick: int = 0  # append tick this segment arrived at (decay ages off it)
    # (device, CUDA event) pairs recorded after the planes were built when
    # that happened on other streams than the queries' (a compaction's),
    # else None
    ready: Any = None

    @property
    def k(self) -> int:
        return len(self.local_items)

    @property
    def planes(self):
        """Data shard 0's planes: the whole segment on a one-shard mesh."""
        return self.shard_planes[0]

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes)

    @property
    def device_bytes(self) -> int:
        """Bytes of the segment's device state (its planes, every shard)."""
        return sum(int(p.numel() * p.element_size()) for p in self.shard_planes)


def segment_handles(segments: "list[Segment]", order_arr: np.ndarray) -> list[SegmentHandle]:
    """Wave handles for ``segments`` against a global rank space given as
    ``order_arr`` (rank -> item). ``g2l`` routes ranks a segment never saw
    (items first seen in later batches, or absent from it) to the sentinel
    row."""
    out = []
    for s in segments:
        loc = s.item_to_local[order_arr]
        g2l = np.where(loc >= 0, loc, s.k).astype(np.int32)
        out.append(SegmentHandle(planes=s.shard_planes,
                                 singleton=tuple(p[2] for p in s.shard_planes), g2l=g2l,
                                 ready=s.ready))
    return out


class SegmentedDB:
    """Ordered segments + merged global state for one stream."""

    def __init__(self, n_items: int):
        self.n_items = int(n_items)
        self.segments: list[Segment] = []
        self.rank_of = np.full(n_items, -1, np.int32)  # item -> stream rank
        self.order: list[int] = []  # stream rank -> item
        self.counts = np.zeros(n_items, np.int64)  # global Job 1 reduce
        self.C = np.zeros((0, 0), np.int64)  # global F2 reduce (triu, rank space)
        self.n_rows = 0  # real appended transactions (thresholds resolve here)

    @property
    def n_ranked(self) -> int:
        return len(self.order)

    # --------------------------------------------------------- item order
    def register_batch(self, hist: np.ndarray) -> np.ndarray:
        """Fold one batch histogram into the global counts, assigning
        stream ranks to never-seen items (by batch support descending,
        ties item-ascending — deterministic, so a replayed stream
        reproduces the exact same rank space). Returns the new items."""
        present = np.flatnonzero(hist > 0)
        fresh = present[self.rank_of[present] < 0]
        if len(fresh):
            fresh = fresh[np.lexsort((fresh, -hist[fresh]))]
            self.rank_of[fresh] = np.arange(
                self.n_ranked, self.n_ranked + len(fresh), dtype=np.int32
            )
            self.order.extend(int(i) for i in fresh)
            grown = np.zeros((self.n_ranked, self.n_ranked), np.int64)
            grown[: self.C.shape[0], : self.C.shape[1]] = self.C
            self.C = grown
        self.counts += hist
        return fresh

    def present_in_order(self, hist: np.ndarray) -> np.ndarray:
        """Items of one batch, sorted by stream rank (the order its
        segment F-list must use). Call after ``register_batch``."""
        present = np.flatnonzero(hist > 0)
        return present[np.argsort(self.rank_of[present], kind="stable")].astype(np.int32)

    # ----------------------------------------------------------- segments
    def add_segment(self, seg: Segment) -> None:
        """Append a segment and fold its F2 matrix into the global one.
        The local C is in local rank space; local order is the stream
        order restricted to the segment's items, so the embedding by
        global ranks is monotone and stays upper-triangular."""
        gr = self.rank_of[seg.local_items]
        self.C[np.ix_(gr, gr)] += seg.prepared.C
        self.segments.append(seg)

    def drop_segments(self, victim_ids: set[int]) -> "list[Segment]":
        """The retraction primitive: remove the named segments and
        subtract their aggregates from the global state — the exact
        inverse of ``register_batch`` + ``add_segment``, because supports
        are additive over disjoint partitions. Item ranks are append-only
        and stay assigned (an item whose every occurrence expired simply
        reports count 0, i.e. infrequent at any positive threshold), so
        the stream rank space — and with it every surviving segment's
        packed layout and snapshot key — is untouched. Returns the
        dropped segments, oldest first."""
        dropped = [s for s in self.segments if s.seg_id in victim_ids]
        if not dropped:
            return []
        self.segments = [s for s in self.segments if s.seg_id not in victim_ids]
        for s in dropped:
            gr = self.rank_of[s.local_items]
            self.C[np.ix_(gr, gr)] -= s.prepared.C
            self.counts -= enc.item_support(s.rows, self.n_items)
            self.n_rows -= s.n_rows
        return dropped

    def replace_segments(self, victim_ids: set[int], merged: Segment) -> bool:
        """Swap compacted segments for their merge, preserving order (the
        merge lands at the earliest victim's position). Global counts and
        C are untouched: the merged segment's aggregates equal the sum of
        its parts, which are already folded in — which is also why a
        compaction pass cannot change any query answer.

        Returns False — and swaps NOTHING — when any victim is no longer
        live: a sliding window may have expired it while an async merge
        was in flight, and installing the merge would resurrect retracted
        rows. The discarded pass wasted only prep work."""
        live = {s.seg_id for s in self.segments}
        if not victim_ids <= live:
            return False
        out, placed = [], False
        for s in self.segments:
            if s.seg_id in victim_ids:
                if not placed:
                    out.append(merged)
                    placed = True
                continue
            out.append(s)
        self.segments = out
        return True

    def handles(self) -> list[SegmentHandle]:
        """Per-segment wave handles against the *current* global rank
        space (module-level ``segment_handles`` over this db's order)."""
        return segment_handles(self.segments, np.asarray(self.order, np.int32))

    def digest(self) -> str:
        """Segment-set digest: identifies the exact segment layout (used
        to key caches/telemetry on the live stream state)."""
        h = hashlib.sha1()
        for s in self.segments:
            h.update(s.digest.encode())
        h.update(str(self.n_rows).encode())
        return h.hexdigest()

    def stats(self) -> dict:
        return {
            "segments": len(self.segments),
            "rows": self.n_rows,
            "batches": sum(s.n_batches for s in self.segments),
            "items_ranked": self.n_ranked,
            "segment_rows": [s.n_rows for s in self.segments],
            "bytes": sum(s.nbytes for s in self.segments),
        }
