"""StreamingMiner: incremental ingestion over a ``SegmentedDB``.

``append(rows_batch)`` is the paper's *map* step run on only the new
partition: one host histogram, then Job 2 / pack / F2 on the batch alone
(``HPrepostMiner.prepare`` with the stream's imposed global item order) —
never a rebuild of earlier segments. ``mine(spec)`` is the *reduce*:
global F1/F2 come from summed per-segment counts, and the k>2 wave loop
plans candidates once against the global F-lists while launching the
fused intersect kernel per segment, summing per-candidate supports across
segments before thresholding (``mine_prepared_segments``). Exactness
rides on support additivity over disjoint partitions plus the shared
stream item order every segment's tree is built in.

With a floor (``StreamSpec.min_sup_floor``) an append folds the batch's
histogram, expires what the window drops, admits the items whose window
count reaches the floor and only then builds the segment, over the batch's
admitted items; a query first prepares again any segment that lacks an
item admitted since it was built (``_readmit``), then plans over the
admitted items alone. A stationary window admits the same items at every
append, and so re-prepares nothing.

Per-segment persistence: with the engine's ``SnapshotStore`` bound, every
segment build is spilled under a key extended with the segment's imposed
item order (same batch + same stream history -> same key), so a restarted
process replaying its append log warm-starts every already-seen segment
with **zero** prep stages (``stats["seg_prepares"] == 0``).

Compaction (LSM-style): when the ``StreamSpec`` thresholds trip, the
smallest segments' host rows are merged and re-prepared as one segment —
global counts/C are untouched (the merge's aggregates equal the sum of
its parts), so query answers are bit-for-bit unchanged. With
``compact_async`` the merge runs on a background thread, off the
append/query path, and swaps in when ready.

On CUDA, an append's segment is built on the appending thread's current
stream, which is the stream its queries run on (the service serves both
from its worker thread). A compaction may run on a thread of its own
(``compact_async``), whose current stream would be the device's default
stream; so every merge is built under the stream's own compaction streams
(one per CUDA device of the miner's mesh), which record an event each after
the build. A query waits on those events before its first wave on the
segment and ``record_stream``s the planes on its own streams (see
``LocalSegmentExecutor.begin``), so a later drop of the segment cannot have
the caching allocator reuse a block while a wave still reads it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import encoding as enc
from repro_torch.core.hprepost import PreparedDB
from repro_torch.device import on_streams, record_ready, side_streams
from repro_torch.fault import failures
from repro_torch.mining.engine import MiningEngine
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec
from repro_torch.mining.stream.segmented import Segment, SegmentedDB, segment_handles
from repro_torch.mining.stream.spec import StreamSpec
from repro_torch.mining.telemetry import trace

# content identity of a row block — the engine's fingerprint digest, so
# stream snapshot keys and engine fingerprints can never drift apart
_digest = MiningEngine._digest


def segment_key(digest: tuple, local_items: np.ndarray, n_items: int,
                device_cfg, n_shards: int) -> str:
    """On-disk identity of a segment build: the batch content, the imposed
    item order (the same rows appended into a different stream history pack
    differently!), the prep-level device config, and the shard count.
    Execution-only knobs (``la_block``, backend, early_stop, tune) are
    normalized away via ``prep_key`` — a retune or backend switch must keep
    warm-restoring segments."""
    from repro_torch.mining.service.store import SnapshotStore

    items_digest = hashlib.sha1(
        np.ascontiguousarray(local_items, np.int32).tobytes()
    ).hexdigest()
    return SnapshotStore.key_for(
        "hprepost-seg", digest, n_items,
        {"cfg": dataclasses.asdict(device_cfg.prep_key()),
         "stream_items": items_digest},
        n_shards,
    )


def build_segment(miner, store, n_items: int, rows: np.ndarray, n_rows_real: int,
                  hist: np.ndarray, local_items: np.ndarray, *, seg_id: int,
                  device_cfg, row_pad: int, stats: dict) -> tuple[Segment, str]:
    """Prepare one batch as a segment: snapshot warm-start when ``store``
    already holds this (rows, imposed item order, device config) triple,
    else run the prep stages on the batch (with the imposed F-list: no
    histogram kernel, Job 2 / pack / F2 only). ``stats`` gets the
    ``seg_prepares`` / ``seg_snapshot_*`` counters bumped in place.

    The N-lists are then laid out once per data shard as the wave kernel's
    planes, sentinel row included, and ``prepared.packed`` becomes views of
    them: after the snapshot spill nothing needs a second device copy.
    With no ``local_items`` (a floored stream's batch with no admitted
    item) the segment is hollow: rows and histogram, no prep."""
    R0 = len(rows)
    Rp = -(-R0 // row_pad) * row_pad
    if Rp != R0:
        padded = np.full((Rp, rows.shape[1]), enc.PAD, np.int32)
        padded[:R0] = rows
        rows = padded
    present = np.flatnonzero(hist > 0)
    digest = _digest(rows)
    item_to_local = np.full(n_items, -1, np.int32)
    item_to_local[local_items] = np.arange(len(local_items), dtype=np.int32)
    if not len(local_items):  # hollow: no admitted item to prepare
        seg = Segment(
            seg_id=seg_id, rows=rows, n_rows=int(n_rows_real), prepared=None,
            shard_planes=(), local_items=local_items, item_to_local=item_to_local,
            digest=digest[2], present=present, present_counts=hist[present],
        )
        return seg, "hollow"
    fl = enc.FList(
        items=local_items,
        supports=hist[local_items].astype(np.int64),
        n_items=n_items,
        min_count=1,
    )
    key = segment_key(digest, local_items, n_items, device_cfg, miner.D)
    prepared = None
    source = "built"
    if store is not None:
        try:
            payload = store.get(key)
        except Exception:
            payload = None
        if payload is not None:
            try:
                prepared = PreparedDB.from_host(payload, miner)
            except ValueError:
                prepared = None
        if prepared is not None:
            stats["seg_snapshot_hits"] += 1
            source = "snapshot"
        else:
            stats["seg_snapshot_misses"] += 1
    if prepared is None:
        prepared = miner.prepare(rows, n_items, 1, flist=fl)
        stats["seg_prepares"] += 1
        if store is not None:
            try:
                store.put(key, prepared.to_host())
            except Exception:
                stats["seg_snapshot_spill_failures"] += 1
    shard_planes = tuple(miner.extend_with_sentinel(prepared, d)[0] for d in range(miner.D))
    prepared.packed = tuple(p[:, :prepared.fl.k].permute(1, 2, 0) for p in shard_planes)
    seg = Segment(
        seg_id=seg_id, rows=rows, n_rows=int(n_rows_real),
        prepared=prepared, shard_planes=shard_planes,
        local_items=local_items, item_to_local=item_to_local,
        digest=digest[2], present=present, present_counts=hist[present],
    )
    trace.count("stream.kept_items", len(local_items))
    return seg, source


class StreamingMiner:
    """One live, append-only mining stream bound to a ``MiningEngine``.

    ``spec`` fixes the device-level configuration (and so the resident
    ``HPrepostMiner``) for every segment and query of this stream; query
    specs may vary threshold / ``max_k`` / ``patterns`` freely but must
    agree on the device knobs. Appends and queries are serialized per
    stream by one lock; async compaction prepares outside it.
    """

    def __init__(self, engine, n_items: int, *, spec: MineSpec | None = None,
                 stream_spec: StreamSpec | None = None, name: str = "default"):
        self.engine = engine
        self.name = name
        self.n_items = int(n_items)
        self.spec = spec if spec is not None else MineSpec()
        self.stream_spec = stream_spec if stream_spec is not None else StreamSpec()
        self._fe = engine.frontend("hprepost")
        self._device_cfg = self._fe._device_config(self.spec)
        self.miner = self._fe.miner_for(self.spec)
        self.db = SegmentedDB(n_items, floor=self.stream_spec.min_sup_floor)
        self._lock = threading.RLock()
        self._next_seg = 0
        self._tick = 0  # append ticks (decay ages segments off this)
        self.rows_appended = 0  # monotone: never decremented by expiry
        # window ledger for segment-less appends (all-PAD batches): their
        # rows count toward n_rows and must age out of the window like any
        # others, ordered by append tick against the segments
        self._empty_trail: list[list[int]] = []  # [tick, n_rows]
        self._compact_pending: set[int] | None = None
        self._compact_future = None
        self._compact_pool: ThreadPoolExecutor | None = None
        # the compaction's own CUDA streams, one per device of the miner's
        # mesh (see the module docstring); None until the first compaction
        self._compact_streams: list | None = None
        from repro_torch.mining.continuous import StandingRegistry

        self.standing = StandingRegistry(self)
        self.stats = {
            "appends": 0, "queries": 0, "empty_batches": 0,
            "seg_prepares": 0,  # segment builds that ran real prep stages
            "seg_snapshot_hits": 0, "seg_snapshot_misses": 0,
            "seg_snapshot_spill_failures": 0,
            "compactions": 0, "segments_compacted": 0, "compact_errors": 0,
            "compact_discarded": 0,  # merges dropped: a victim expired mid-flight
            # sliding-window churn (ROADMAP item 3 operator surface)
            "expires": 0, "expired_segments": 0, "expired_rows": 0,
            "expire_errors": 0,
            # standing-query delivery telemetry
            "standing_queries": 0, "diffs_delivered": 0, "diff_errors": 0,
            "diff_latency_s_total": 0.0, "last_diff_latency_s": 0.0,
            "seed_pruned_candidates": 0,
        }
        if self.db.floor > 0:
            self.stats["readmits"] = 0  # segments prepared again (``_readmit``)

    # -------------------------------------------------------------- append
    def append(self, rows_batch) -> dict:
        """Ingest one batch of transactions (the map step on the new
        partition only). Returns per-append telemetry; the batch is
        copied, so callers may keep mutating their array."""
        rows = np.array(rows_batch, np.int32, copy=True)
        if rows.ndim != 2:
            raise ValueError(f"rows batch must be 2-D (R, L), got shape {rows.shape}")
        if rows.size and int(rows.max()) >= self.n_items:
            raise ValueError(
                f"batch contains item id {int(rows.max())} >= n_items={self.n_items}"
            )
        t0 = time.perf_counter()
        with trace.span("stream.append", stream=self.name), self._lock:
            self._reap_compaction()
            with trace.span("stream.fold"):
                hist = enc.item_support(rows, self.n_items)
                self.db.counts += hist
                self.db.n_rows += len(rows)
            self.stats["appends"] += 1
            self.rows_appended += len(rows)
            self._tick += 1  # one decay tick per append: history ages now
            incoming = hist.sum() > 0
            if not incoming:
                self.stats["empty_batches"] += 1
                if self.stream_spec.windowed and len(rows):
                    self._empty_trail.append([self._tick, len(rows)])
            # expiry first, so that the batch is built with the items the
            # window it joins admits: a stationary window then re-prepares
            # nothing
            n_seg_expired, n_rows_expired = self._expire(
                (self._tick, 1, len(rows)) if incoming else None)
            with trace.span("stream.fold"):
                new_items = self.db.admit()
            source = "empty"
            if incoming:
                local_items = self.db.present_in_order(hist)
                seg, source = self._build_segment(rows, len(rows), hist, local_items)
                seg.tick = self._tick
                with trace.span("stream.fold"):
                    self.db.add_segment(seg)
            self._maybe_compact()
            diffs = self.standing.refresh_all(
                "expire" if n_rows_expired else "append")
            append_s = time.perf_counter() - t0
            self.engine.telemetry.histogram(
                f"stream.{self.name}.append_s").record(append_s)
            return {
                "rows": int(len(rows)),
                "total_rows": int(self.db.n_rows),
                "segments": len(self.db.segments),
                "new_items": int(len(new_items)),
                "expired": n_seg_expired,
                "expired_rows": n_rows_expired,
                "diffs": int(diffs),
                "prep_source": source,
                "append_s": append_s,
            }

    def _expire(self, incoming=None) -> tuple[int, int]:
        """Sliding-window expiry (lock held): drop the oldest appends —
        segments and segment-less all-PAD batches alike, ordered by their
        append tick — until the retained suffix is the minimal one still
        covering the window (``window_rows`` real rows /
        ``window_batches`` batches). ``incoming``, ``(tick, batches,
        rows)``, is an append whose segment is not built yet: it counts
        toward the window as the newest. The newest append always survives.
        Returns (segments dropped, rows dropped). An injected expiry
        failure (``stream.expire``) skips the pass and is only accounted —
        the window self-heals on the next append, and every answer in
        between is still exact over the (briefly wider) retained suffix."""
        ss = self.stream_spec
        if not ss.windowed:
            return 0, 0
        # (tick, size, segment-or-None, rows) in append order
        by_batches = bool(ss.window_batches)
        entries = [
            (s.tick, s.n_batches if by_batches else s.n_rows, s, s.n_rows)
            for s in self.db.segments
        ] + [(t, 1 if by_batches else n, None, n) for t, n in self._empty_trail]
        if incoming is not None:  # the newest entry, so never a victim
            t, b, n = incoming
            entries.append((t, b if by_batches else n, False, n))
        entries.sort(key=lambda e: e[0])
        if len(entries) <= 1:
            return 0, 0
        window = ss.window_batches or ss.window_rows
        total = sum(e[1] for e in entries)
        victims, i = [], 0
        while i < len(entries) - 1 and total - entries[i][1] >= window:
            total -= entries[i][1]
            victims.append(entries[i])
            i += 1
        if not victims:
            return 0, 0
        try:
            failures.fire("stream.expire")
        except Exception:
            self.stats["expire_errors"] += 1
            return 0, 0
        t_ex = time.perf_counter()
        with trace.span("stream.expire"):
            seg_victims = {e[2].seg_id for e in victims if e[2] is not None}
            dropped = self.db.drop_segments(seg_victims) if seg_victims else []
            empty_ticks = {e[0] for e in victims if e[2] is None}
            empty_rows = sum(n for t, n in self._empty_trail if t in empty_ticks)
            if empty_ticks:
                self._empty_trail = [
                    e for e in self._empty_trail if e[0] not in empty_ticks]
                self.db.n_rows -= empty_rows
        n_rows = sum(s.n_rows for s in dropped) + empty_rows
        self.stats["expires"] += 1
        self.stats["expired_segments"] += len(dropped)
        self.stats["expired_rows"] += n_rows
        self.engine.telemetry.histogram(f"stream.{self.name}.expire_s").record(
            time.perf_counter() - t_ex
        )
        return len(dropped), n_rows

    # ----------------------------------------------------- standing queries
    def register(self, spec: MineSpec):
        """Register a standing query: mined now (the initial delivery) and
        after every append/expiry from here on. Returns the
        ``StandingQuery`` whose ``next_diff()`` Futures resolve in
        arrival order with each delivered ``MineDiff``."""
        with self._lock:
            return self.standing.register(spec)

    def cancel(self, query) -> None:
        with self._lock:
            self.standing.cancel(query)

    def _build_segment(self, rows: np.ndarray, n_rows_real: int,
                       hist: np.ndarray, local_items: np.ndarray) -> tuple[Segment, str]:
        """Prepare one batch as a segment (module-level ``build_segment``
        with this stream's miner/store/config bound)."""
        # seg-id allocation must be atomic: an append (stream lock held)
        # and an async compaction job (deliberately outside the lock)
        # both build segments, and a duplicated id would let
        # replace_segments clobber a live segment
        with self._lock:
            seg_id = self._next_seg
            self._next_seg += 1
        seg, source = build_segment(
            self.miner, self.engine.snapshot_store, self.n_items,
            rows, n_rows_real, hist, local_items,
            seg_id=seg_id, device_cfg=self._device_cfg,
            row_pad=self.stream_spec.row_pad, stats=self.stats,
        )
        return seg, source

    # --------------------------------------------------------------- query
    def mine(self, spec: MineSpec, _seed=None, _seed_out=None) -> MineResult:
        """Serve one query from the live ``SegmentedDB`` (the reduce step
        + cross-segment waves). Prep was paid at append time, so results
        carry ``prep_shared`` and zeroed prep stage keys.

        With ``StreamSpec.decay < 1`` the query runs the damped-window
        reduce instead: per-segment supports weighted by age in float64,
        float threshold post-reduce (``repro_torch.mining.continuous.decay``).
        ``_seed`` / ``_seed_out`` are the standing-query refresh hooks —
        per-itemset support bounds from the previous answer's settled
        waves, passed through to the planner's upper-bound prune (exact
        integer mode only; never changes the answer)."""
        if spec.algorithm != "hprepost":
            raise ValueError(
                f"stream queries run on the hprepost backend, got {spec.algorithm!r}"
            )
        # only prep-level knobs are pinned by the packed segments;
        # execution-only knobs (blocks, backend, early_stop, tune) are free
        # to differ per query and are honored via the query's own miner
        if self._fe._prep_config(spec) != self._device_cfg.prep_key():
            raise ValueError(
                "query device config differs from the stream's; segments were "
                "packed under the stream spec — open a new stream to change knobs"
            )
        self._fe._check_patterns(spec)
        with trace.span("stream.query", stream=self.name):
            return self._mine(spec, _seed, _seed_out)

    def _mine(self, spec: MineSpec, _seed, _seed_out) -> MineResult:
        t0 = time.perf_counter()
        decay = self.stream_spec.decay
        weights = None
        with self._lock:
            self._reap_compaction()
            if self.db.floor > 0:
                self._check_floor(spec)
                self._readmit()
            items, C = self.db.query_state()
            handles = segment_handles(self.db.segments, items)
            n_rows = self.db.n_rows
            n_segs = len(handles)
            seg_digest = self.db.digest()
            if decay < 1.0:
                from repro_torch.mining import continuous as cont

                spec.resolve(max(n_rows, 1))  # threshold-shape validation only
                weights = cont.segment_weights(self.db.segments, self._tick, decay)
                _, sups, C, wrows = cont.weighted_state(self.db, weights)
                min_count = cont.resolve_weighted(spec, wrows)
                peak_floor = max(int(min_count), 1)
                wrows_snapshot = float(wrows)
            else:
                sups = self.db.counts[items] if len(items) else np.zeros(0, np.int64)
                min_count = spec.resolve(max(n_rows, 1))
                peak_floor = min_count
            peak_base = sum(
                s.prepared.bytes_at(peak_floor, self.miner.D)
                for s in self.db.segments if s.prepared is not None
            )
        if len(items) > spec.max_f1:
            raise ValueError(
                f"|stream F-list|={len(items)} exceeds max_f1={spec.max_f1}"
            )
        qminer = self._fe.miner_for(spec)  # honors execution-only knobs
        res = qminer.mine_prepared_segments(
            handles, items, sups, C, min_count, max_k=spec.max_k,
            peak_base=peak_base, weights=weights,
            seed=_seed if decay == 1.0 else None,
            seed_out=_seed_out if decay == 1.0 else None,
        )
        self.stats["queries"] += 1
        self.engine.telemetry.histogram(f"stream.{self.name}.query_s").record(
            time.perf_counter() - t0
        )
        out = self._fe._finish(
            res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
            dict(qminer.last_stage_times), res.flist_items,
            spec=spec, min_count=min_count, n_rows=n_rows, t0=t0, prep_shared=True,
        )
        out.service_stats.update(
            prep_source="stream", stream_segments=n_segs, stream_digest=seg_digest
        )
        if decay < 1.0:
            out.service_stats.update(decay=decay, weighted_rows=wrows_snapshot)
        return out

    def _check_floor(self, spec: MineSpec) -> None:  # lock held
        """Refuse a query whose threshold is below the stream's floor: the
        segments hold only the items the floor admits."""
        min_count = spec.resolve(max(self.db.n_rows, 1))
        floor_count = self.db.floor_count()
        if min_count < floor_count:
            asked = (f"min_sup={spec.min_sup}" if spec.min_count is None
                     else f"min_count={spec.min_count}")
            raise ValueError(
                f"query threshold {asked} (min_count {min_count} of {self.db.n_rows} rows) "
                f"is below the stream's floor min_sup_floor={self.db.floor} "
                f"(min_count {floor_count})"
            )

    def _readmit(self) -> None:  # lock held
        """Prepare again every live segment whose tree no longer fits the
        admitted items (``SegmentedDB.stale``) from its host rows, and
        swap it in, its F2 matrix folded out and the new one in; then give
        up the ranks no segment holds any more. Exact answers need it
        whatever order the batches were built in; a stationary window
        re-prepares nothing."""
        self.db.admit()
        adm = self.db.admitted()
        stale = [s for s in self.db.segments if self.db.stale(s, adm)]
        for old in stale:
            with trace.span("stream.readmit", segment=old.seg_id):
                hist = old.hist(self.n_items)
                new, _ = self._build_segment(
                    old.rows, old.n_rows, hist, self.db.present_in_order(hist))
                new.tick, new.n_batches = old.tick, old.n_batches
                self.db.swap_segment(old, new)
        if stale:
            self.db.admit()
        self.stats["readmits"] += len(stale)
        trace.count("stream.readmitted_segments", len(stale))

    # ---------------------------------------------------------- compaction
    def _needs_compaction(self) -> bool:
        ss = self.stream_spec
        segs = self.db.segments
        if ss.decay < 1.0:
            # decayed supports need per-segment ages; a merged segment has
            # none — the spec validated the triggers are compatible
            return False
        if len(segs) < 2:
            return False
        if len(segs) > ss.max_segments:
            return True
        if ss.small_rows > 0:
            total = sum(s.nbytes for s in segs)
            small = [s for s in segs if s.n_rows < ss.small_rows]
            if (len(small) >= 2 and total
                    and sum(s.nbytes for s in small) / total > ss.small_byte_frac):
                return True
        return False

    def _maybe_compact(self) -> None:  # lock held
        if self._compact_pending is None and self._needs_compaction():
            try:
                self._launch_compaction()
            except Exception:
                # an auto-triggered (possibly sync) compaction failure must
                # not fail the append that tripped it — the batch is already
                # ingested and the uncompacted layout answers exactly; the
                # job accounted the error in stats["compact_errors"]
                pass

    def compact(self, *, wait: bool = True) -> dict:
        """Force one compaction pass (merge the ``compact_fanin`` smallest
        segments), regardless of the thresholds. ``wait=False`` with
        ``compact_async`` returns once the pass is scheduled. Unlike the
        auto trigger (which swallows failures — appends must not break on
        a background merge), an explicit pass propagates a sync failure to
        its caller."""
        if self.stream_spec.decay < 1.0:
            raise ValueError(
                "decayed streams do not compact: a merged segment has no "
                "single age for the damping weight"
            )
        with self._lock:
            self._reap_compaction()
            if self._compact_pending is None and len(self.db.segments) >= 2:
                self._launch_compaction()
        if wait:
            self.flush()
        with self._lock:
            return {"segments": len(self.db.segments),
                    "compactions": self.stats["compactions"]}

    def _launch_compaction(self) -> None:  # lock held
        segs = self.db.segments
        fanin = min(self.stream_spec.compact_fanin, len(segs))
        if fanin < 2:
            return
        if self.stream_spec.windowed:
            # expiry is segment-granular off the append-order prefix: a
            # merge of non-adjacent segments would fuse rows of different
            # ages and break the window boundary — victims must be a
            # contiguous run (the lightest one)
            start = min(
                range(len(segs) - fanin + 1),
                key=lambda i: sum(s.n_rows for s in segs[i:i + fanin]),
            )
            victims = list(segs[start:start + fanin])
        else:
            victims = sorted(segs, key=lambda s: (s.n_rows, s.seg_id))[:fanin]
        self._compact_pending = {v.seg_id for v in victims}
        if self.stream_spec.compact_async:
            if self._compact_pool is None:
                self._compact_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="stream-compact"
                )
            self._compact_future = self._compact_pool.submit(self._compact_job, victims)
        else:
            try:
                self._compact_job(victims)
            except BaseException:
                # the job's own handler normally clears the in-flight marker,
                # but whatever failed, a dead sync pass must never leave the
                # stream wedged (unable to ever launch another)
                self._compact_pending = None
                raise

    def _compact_job(self, victims: list[Segment]) -> None:
        """Merge the victims' host rows and re-prepare them as one segment
        (possibly on the compaction thread — the expensive prepare runs
        outside the stream lock, so appends/queries proceed against the
        uncompacted layout, which answers identically). On CUDA the build
        runs under the compaction stream and hands the segment over with an
        event (see the module docstring)."""
        try:
            L = max(v.rows.shape[1] for v in victims)
            R = sum(len(v.rows) for v in victims)
            rows = np.full((R, L), enc.PAD, np.int32)
            at = 0
            for v in victims:
                rows[at:at + len(v.rows), : v.rows.shape[1]] = v.rows
                at += len(v.rows)
            hist = sum(v.hist(self.n_items) for v in victims)
            with self._lock:
                # the merge holds the items admitted now; if their ranks
                # change before it is installed, ``replace_segments``
                # refuses it
                local_items = self.db.present_in_order(hist)
            if self._compact_streams is None:
                self._compact_streams = side_streams(self.miner.devices)
            with on_streams(self._compact_streams):
                merged, _ = self._build_segment(
                    rows, sum(v.n_rows for v in victims), hist, local_items)
                merged.ready = record_ready(self._compact_streams)
            merged.n_batches = sum(v.n_batches for v in victims)
            merged.tick = max(v.tick for v in victims)
            with self._lock:
                if self.db.replace_segments({v.seg_id for v in victims}, merged):
                    self.stats["compactions"] += 1
                    self.stats["segments_compacted"] += len(victims)
                else:
                    # a victim expired while the merge was in flight;
                    # installing it would resurrect retracted rows
                    self.stats["compact_discarded"] += 1
                self._compact_pending = None
                self._compact_future = None
        except BaseException:
            with self._lock:
                self.stats["compact_errors"] += 1
                self._compact_pending = None
                self._compact_future = None
            raise

    def _reap_compaction(self) -> None:  # lock held; non-blocking
        f = self._compact_future
        if f is not None and f.done():
            # a successful job cleared itself; only a failure lingers here
            exc = f.exception()
            self._compact_future = None
            self._compact_pending = None
            if exc is not None:
                self.stats["compact_errors"] += 1

    def flush(self) -> None:
        """Block until any in-flight compaction has swapped in (or
        failed). Never called with the stream lock held — the job needs
        the lock to swap."""
        f = self._compact_future
        if f is not None:
            try:
                f.result()
            except BaseException:
                pass  # accounted by the job / _reap_compaction
        with self._lock:
            self._reap_compaction()

    def close(self) -> None:
        self.flush()
        if self._compact_pool is not None:
            self._compact_pool.shutdown(wait=True)
            self._compact_pool = None
