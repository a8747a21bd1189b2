"""SegmentedDB: an ordered collection of per-batch prepared segments plus
the merged global aggregates the reduce step needs.

The paper's MapReduce observation, kept live instead of re-derived: PPC
trees / N-lists built over *disjoint* transaction partitions are
independent map outputs, and per-itemset supports are additive in the
reduce. A ``SegmentedDB`` therefore holds

  - one ``Segment`` per appended batch (its host rows for later
    compaction, its ``PreparedDB``, and its sentinel-extended N-list planes
    on the device, ready for cross-segment waves),
  - the **stream item order**: a map item -> global rank, assigned at
    *admission*. Every segment's PPC tree is built in this shared order
    (``HPrepostMiner.prepare(flist=...)``), which is what makes
    cross-segment N-list intersections exact — ancestor relations agree
    across all segments, and a segment's local rank space is an
    order-preserving subset of the global one,
  - the merged global item counts (summed per-batch histograms — the
    streaming Job 1 reduce) and the merged F2 co-occurrence matrix in
    stream-rank space (summed per-segment ``PreparedDB.C``, embedded
    monotonically — the streaming F2 reduce).

Admission follows the stream's **floor** (``StreamSpec.min_sup_floor``),
the loosest ``min_sup`` it answers. At floor 0 an item is admitted when it
first appears and keeps its rank for good. With a floor > 0 an item is
admitted while its count over the retained rows reaches ``floor_count``;
only admitted items are ranked and held by segments built from then on,
so ``C`` covers the admitted items (plus those a live segment still
holds), not the item universe. An item that is neither admitted nor held
by any live segment gives its rank up; the ranks after it close up, which
keeps every held item's relative order, and so every segment's layout.

Pure data structure: no device work and no locking here — the
``StreamingMiner`` orchestrates both.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import numpy as np

from repro_torch.core.hprepost import PreparedDB, SegmentHandle


@dataclasses.dataclass
class Segment:
    """One appended batch, prepared and device-resident.

    A segment none of whose items is admitted (a floored stream) is
    *hollow*: ``prepared`` is None, it has no planes and answers no wave,
    and it keeps its rows and histogram for a later re-prepare.

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
    # the batch's histogram: the items present (ascending) and their counts,
    # which expiry subtracts and a re-prepare reads
    present: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    present_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
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

    def hist(self, n_items: int) -> np.ndarray:
        """The batch's dense ``(n_items,)`` histogram."""
        out = np.zeros(n_items, np.int64)
        out[self.present] = self.present_counts
        return out

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
        if s.prepared is None:
            continue  # hollow: holds none of the ranks, adds 0 everywhere
        loc = s.item_to_local[order_arr]
        g2l = np.where(loc >= 0, loc, s.k).astype(np.int32)
        out.append(SegmentHandle(planes=s.shard_planes, g2l=g2l, ready=s.ready))
    return out


class SegmentedDB:
    """Ordered segments + merged global state for one stream."""

    def __init__(self, n_items: int, floor: float = 0.0):
        self.n_items = int(n_items)
        self.floor = float(floor)  # the loosest min_sup the stream answers
        self.segments: list[Segment] = []
        self.rank_of = np.full(n_items, -1, np.int32)  # item -> stream rank
        self.order: list[int] = []  # stream rank -> item
        self.counts = np.zeros(n_items, np.int64)  # global Job 1 reduce
        self.held = np.zeros(n_items, np.int32)  # live segments whose tree holds the item
        # global F2 reduce (triu, rank space) in a buffer that grows by
        # doubling, so a new rank does not copy the matrix; ``C`` is its
        # (n_ranked, n_ranked) corner
        self._C = np.zeros((0, 0), np.int64)
        self.n_rows = 0  # real appended transactions (thresholds resolve here)

    @property
    def n_ranked(self) -> int:
        return len(self.order)

    @property
    def C(self) -> np.ndarray:
        n = self.n_ranked
        return self._C[:n, :n]

    def _grow(self, n: int) -> None:
        """Room in the ``C`` buffer for ``n`` ranks."""
        cap = self._C.shape[0]
        if n > cap:
            grown = np.zeros((max(n, 2 * cap),) * 2, np.int64)
            grown[:cap, :cap] = self._C
            self._C = grown

    # --------------------------------------------------------- item order
    def floor_count(self) -> int:
        """The least window count an item needs to be admitted:
        ``ceil(floor · n_rows)`` as ``MineSpec.resolve`` computes it, and
        at least 1."""
        return max(1, math.ceil(self.floor * self.n_rows - 1e-9))

    def admitted(self) -> np.ndarray:
        """(n_items,) bool: the items the stream admits now."""
        return self.counts >= self.floor_count()

    def admit(self) -> np.ndarray:
        """Rank the admitted items that have no rank yet (by window count
        descending, ties item-ascending — deterministic, so a replayed
        stream reproduces the exact same rank space) after the ranked
        ones; with a floor, give up the ranks of items neither admitted
        nor held by a live segment. Returns the newly ranked items."""
        adm = self.admitted()
        if self.floor > 0:
            gone = [i for i in self.order if not adm[i] and not self.held[i]]
            if gone:
                self._retire(np.asarray(gone, np.int64))
        fresh = np.flatnonzero(adm & (self.rank_of < 0))
        if len(fresh):
            fresh = fresh[np.lexsort((fresh, -self.counts[fresh]))]
            self.rank_of[fresh] = np.arange(
                self.n_ranked, self.n_ranked + len(fresh), dtype=np.int32
            )
            self.order.extend(int(i) for i in fresh)
            self._grow(self.n_ranked)
        return fresh

    def _retire(self, gone: np.ndarray) -> None:
        """Take ``gone``'s ranks away and close the rank space up. No live
        segment holds them, so their rows and columns of ``C`` are zero;
        the ranks after them keep their order."""
        self.rank_of[gone] = -1
        keep = np.flatnonzero(self.rank_of[np.asarray(self.order, np.int64)] >= 0)
        n = len(keep)
        self._C[:n, :n] = self._C[np.ix_(keep, keep)]
        self._C[n:, :] = 0
        self._C[:, n:] = 0
        self.order = [self.order[i] for i in keep]
        self.rank_of[self.order] = np.arange(n, dtype=np.int32)

    def register_batch(self, hist: np.ndarray) -> np.ndarray:
        """Fold one batch histogram into the global counts and admit its
        new items (see ``admit``). Returns the newly ranked items."""
        self.counts += hist
        return self.admit()

    def present_in_order(self, hist: np.ndarray) -> np.ndarray:
        """The admitted items of one batch, sorted by stream rank (the
        order its segment F-list must use). Call after ``admit``."""
        present = np.flatnonzero((hist > 0) & self.admitted())
        return present[np.argsort(self.rank_of[present], kind="stable")].astype(np.int32)

    def in_order(self, items: np.ndarray) -> bool:
        """Whether ``items`` are all ranked, in rank order."""
        r = self.rank_of[items]
        return bool((r >= 0).all() and (np.diff(r) > 0).all())

    def stale(self, seg: Segment, admitted: np.ndarray) -> bool:
        """Whether ``seg``'s tree no longer fits the stream: an admitted
        item its rows hold is missing from it, or the items it holds are
        no longer ranked in its order. Its answers would then not be
        exact, and it has to be prepared again."""
        lost = seg.present[admitted[seg.present]]
        return bool((seg.item_to_local[lost] < 0).any()) or not self.in_order(seg.local_items)

    def query_state(self) -> tuple[np.ndarray, np.ndarray]:
        """The items a query plans over, in rank order, and a private copy
        of their corner of ``C`` (appends fold into ``C`` in place while a
        query's waves run): every ranked item at floor 0, the admitted
        ones with a floor."""
        items = np.asarray(self.order, np.int32)
        if self.floor == 0:
            return items, self.C.copy()
        keep = np.flatnonzero(self.admitted()[items])
        return items[keep], self.C[np.ix_(keep, keep)]

    # ----------------------------------------------------------- segments
    def _fold(self, seg: Segment, sign: int, with_c: bool = True) -> None:
        """Hold (``sign`` 1) or let go of (-1) a segment's items, and add
        or subtract its F2 matrix unless not ``with_c``. The local C is in
        local rank space; local order is the stream order restricted to
        the segment's items, so the embedding by global ranks is monotone
        and stays upper-triangular."""
        self.held[seg.local_items] += sign
        if seg.prepared is None or not with_c:
            return
        gr = self.rank_of[seg.local_items]
        if sign > 0:
            self._C[np.ix_(gr, gr)] += seg.prepared.C
        else:
            self._C[np.ix_(gr, gr)] -= seg.prepared.C

    def add_segment(self, seg: Segment) -> None:
        """Append a segment and fold its F2 matrix into the global one."""
        self._fold(seg, 1)
        self.segments.append(seg)

    def swap_segment(self, old: Segment, new: Segment) -> None:
        """Put ``new`` (a re-prepare of ``old``'s rows) in ``old``'s place,
        folding ``old``'s F2 matrix out and ``new``'s in."""
        self._fold(old, -1)
        self._fold(new, 1)
        self.segments[self.segments.index(old)] = new

    def drop_segments(self, victim_ids: set[int]) -> "list[Segment]":
        """The retraction primitive: remove the named segments and
        subtract their aggregates from the global state — the exact
        inverse of ``register_batch`` + ``add_segment``, because supports
        are additive over disjoint partitions. Each segment's own
        histogram is subtracted; its rows are not counted again. Item
        ranks stay assigned at floor 0 (an item whose every occurrence
        expired simply reports count 0, i.e. infrequent at any positive
        threshold), so the stream rank space — and with it every surviving
        segment's packed layout and snapshot key — is untouched. Returns
        the dropped segments, oldest first."""
        dropped = [s for s in self.segments if s.seg_id in victim_ids]
        if not dropped:
            return []
        self.segments = [s for s in self.segments if s.seg_id not in victim_ids]
        for s in dropped:
            self._fold(s, -1)
            self.counts[s.present] -= s.present_counts
            self.n_rows -= s.n_rows
        return dropped

    def replace_segments(self, victim_ids: set[int], merged: Segment) -> bool:
        """Swap compacted segments for their merge, preserving order (the
        merge lands at the earliest victim's position). At floor 0 global
        counts and C are untouched: the merged segment's aggregates equal
        the sum of its parts, which are already folded in — which is also
        why a compaction pass cannot change any query answer. With a floor
        the merge holds the items admitted when it was built, which its
        parts need not have held, so their C is folded out and its in.

        Returns False — and swaps NOTHING — when any victim is no longer
        live: a sliding window may have expired it while an async merge
        was in flight, and installing the merge would resurrect retracted
        rows; or when the ranks of the items the merge holds changed
        while it was built. The discarded pass wasted only prep work."""
        live = {s.seg_id for s in self.segments}
        if not victim_ids <= live:
            return False
        if not self.in_order(merged.local_items):
            return False
        out, placed = [], False
        for s in self.segments:
            if s.seg_id in victim_ids:
                if not placed:
                    out.append(merged)
                    placed = True
                self._fold(s, -1, with_c=self.floor > 0)
                continue
            out.append(s)
        self._fold(merged, 1, with_c=self.floor > 0)
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
