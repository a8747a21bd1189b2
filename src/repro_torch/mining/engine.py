"""MiningEngine: a resident mining session on one torch device or a mesh.

The engine binds a device (or a ``repro_torch.launch.mesh.Mesh`` of
devices) once, lazily constructs one frontend per
registered algorithm, and routes every ``submit`` through the unified
``MineSpec -> MineResult`` surface. The hprepost frontend keys its
``HPrepostMiner`` instances on the device-level part of the spec, so
back-to-back submits — sweeps over ``min_sup``, repeated production
queries, mixed-algorithm batches — ride resident miners.

Shared-work planning: the paper's entire experimental surface is the
threshold sweep (every runtime/memory figure is "all min-sup" over one
database), and Job 1 / Job 2 / pack / F2 depend only on the *loosest*
threshold in the sweep. ``sweep`` and ``submit_many`` therefore group
hprepost requests by (database fingerprint, device config), build one
``PreparedDB`` at the group's loosest threshold, and serve every threshold
from it through ``mine_prepared`` — prep runs once per group, not once per
request. Host miners keep the one-shot path.

Persistent PreparedDB cache: the engine keeps an LRU of device-resident
``PreparedDB`` s keyed exactly like planned groups — (database
fingerprint, n_items, prep-level config; execution-only knobs like
``la_block``, backend, and early-stop are normalized away) — under a
configurable byte budget (``prep_cache_bytes``, accounted with
``PreparedDB.prep_bytes``). A cached entry serves any request whose
resolved threshold is at least the entry's floor; looser thresholds (or a
k>1 request hitting an F1-only entry) rebuild at the new floor and replace
it. ``cache_info()`` surfaces hit/miss/eviction counters. An evicted entry
drops the engine's last reference to its device tensors.

Cross-process persistence (the snapshot store): with ``snapshot_dir`` (or
an explicit ``snapshot_store``) bound, every PreparedDB the engine builds
is spilled — atomically, content-addressed, in the reference's on-disk
layout — and every LRU miss consults the store before re-running prep. A
cold process pointed at a populated store therefore warm-starts with
**zero** prep stages on a known database: ``stats["prepares"]`` stays 0
and results carry ``service_stats["prep_source"] == "snapshot"``. The
store requires the LRU to be enabled (``prep_cache_bytes > 0``) — a loaded
snapshot lands in the LRU like any other entry.

Streaming ingestion (``repro_torch.mining.stream``): ``append`` folds a
new transaction batch into a named live ``SegmentedDB`` as its own
prepared segment (the paper's map step, run on the new partition only)
and ``submit_stream`` mines the segmented database via summed
per-segment counts + cross-segment waves (the reduce) — no full rebuild
when data arrives, and per-segment snapshots warm-start a replayed
stream. ``register_standing`` attaches a continuous query
(``repro_torch.mining.continuous``) that is re-answered with a
``MineDiff`` after every append or window expiry.

The engine is thread-safe (one coarse lock over planning state), so the
serving layer (``repro_torch.mining.service``) overlaps one group's
prepare, on a prep thread and its own CUDA stream, with another group's
waves. ``distribute`` opens a distributed database instead: spawned
worker processes (``repro_torch.mining.distributed``), each bound to a
device of its own, behind a coordinator that registers under the same
stream names, so ``append`` / ``submit_stream`` / ``register_standing``
serve it unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
import weakref
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fault import failures
from repro_torch.mining.registry import Miner, get_miner
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec
from repro_torch.mining.service.store import SnapshotStore
from repro_torch.mining.telemetry import Registry, trace
from repro_torch.mining.tune import KernelTuner

# per-stage latency histograms are recorded for these stage_times_s keys
# (only when > 0 — a prep_shared consumer's zeroed prep stages are not
# observations, they are accounting)
_STAGE_KEYS = ("job1_flist", "job2_ppc_pack", "f2_scan", "mining_waves")


@dataclasses.dataclass
class MineRequest:
    """One unit of mining traffic: a database plus its spec.

    ``deadline_at`` is an absolute ``time.monotonic()`` instant stamped by
    the service from ``spec.deadline_s`` at admission; the scheduler drops
    (``DeadlineExceeded``) requests whose deadline passes before their
    device work starts. None = no deadline."""

    rows: object  # (R, L) padded transaction matrix
    n_items: int
    spec: MineSpec
    deadline_at: float | None = None
    # root span id stamped by the service when a tracer is attached, so
    # scheduler/engine spans parent into the request's tree. Like QoS
    # fields, never part of any plan/prep/snapshot key.
    trace_id: int | None = None


class MiningEngine:
    """Session front-door over the miner registry, bound to one torch device
    or to a mesh of them.

    ``device=None`` binds CUDA: the hprepost frontend raises when there is
    none, unless ``device="cpu"`` is given (the plain PyTorch versions of
    the kernels). ``mesh`` (``repro_torch.launch.mesh.make_mesh``) binds a
    D×M mesh instead, with ``data_axis``/``model_axis`` as
    ``HPrepostFrontend`` reads them; every mesh-bound miner in the session
    shares it. Host algorithms ignore both.
    """

    def __init__(self, device=None,
                 prep_cache_bytes: int = 1 << 30,
                 snapshot_dir: str | None = None,
                 snapshot_store: SnapshotStore | None = None,
                 snapshot_bytes: int = 4 << 30, *,
                 mesh=None, data_axis=None, model_axis="model"):
        if mesh is not None and device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        # normalized, not checked: the device miners check it when built.
        # With a mesh, its first position (the hprepost miners' reduce device)
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else torch.device("cuda" if device is None else device))
        self._frontends: dict[str, Miner] = {}
        self.stats = {
            "submits": 0,  # requests answered (planned or not)
            "frontends_built": 0,
            # shared PreparedDB builds made for a *planned group*; ad-hoc
            # submit builds are visible as cache_info()["misses"] instead
            "prepares": 0,
            "prepared_mines": 0,  # requests served from a shared PreparedDB
        }
        # persistent PreparedDB cache: (fingerprint, n_items, prep config)
        # -> (miner, PreparedDB), LRU under a byte budget;
        # prep_cache_bytes <= 0 disables caching entirely
        self.prep_cache_bytes = int(prep_cache_bytes)
        self._prep_cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_stats = {
            "hits": 0, "misses": 0, "evictions": 0,
            "snapshot_hits": 0, "snapshot_misses": 0,
            "snapshot_spill_failures": 0,
        }
        if snapshot_store is None and snapshot_dir is not None:
            snapshot_store = SnapshotStore(snapshot_dir, byte_budget=snapshot_bytes)
        self.snapshot_store = snapshot_store
        # one kernel-plan autotuner per engine, persisted next to the
        # snapshot store (kernel_plans.json) so a warm process reruns its
        # best la_block with zero search trials; attached to every
        # hprepost frontend the engine builds. Plans only resolve through
        # it when a spec opts in (``tune=True``).
        plan_dir = snapshot_dir
        if plan_dir is None and snapshot_store is not None:
            plan_dir = getattr(snapshot_store, "dir", None)
        self.tuner = KernelTuner(plan_dir=plan_dir, platform=self.device.type)
        # engine-lifetime fingerprint memo: id(array) -> (weakref, fp,
        # frozen, sample); compacted (dead weakrefs dropped) when it
        # reaches _fp_sweep_at, which doubles past the live count so
        # sweeps stay amortized O(1). ``frozen`` records that the memo
        # itself made the array read-only (see _fingerprint) and must
        # restore writeability on invalidation; ``sample`` is the
        # stride-sampled digest re-checked on every hit (catches
        # mutation through pre-existing writeable views).
        self._fp_memo: dict[int, tuple[weakref.ref, tuple, bool, str]] = {}
        self._fp_sweep_at = 1024
        # live streaming databases (repro_torch.mining.stream), by name; each
        # StreamingMiner serializes its own appends/queries internally
        self._streams: dict[str, object] = {}
        # the session's latency/counter registry (mining.telemetry), shared
        # by every layer stacked on this engine. Execution-orthogonal: never
        # part of any prep/device/snapshot key.
        self.telemetry = Registry()
        # one coarse re-entrant lock over planning state (frontends, LRU,
        # fingerprint memo, counters); device/host mining itself runs
        # outside it, so threads overlap on the expensive parts only
        self._lock = threading.RLock()

    def frontend(self, algorithm: str) -> Miner:
        """The session's (lazily built, then resident) miner for ``algorithm``."""
        with self._lock:
            fe = self._frontends.get(algorithm)
            if fe is None:
                fe = get_miner(algorithm, **self._placement())
                if hasattr(fe, "tuner"):
                    fe.tuner = self.tuner
                self._frontends[algorithm] = fe
                self.stats["frontends_built"] += 1
            return fe

    def _placement(self) -> dict:
        """Where the frontends run: the engine's mesh, or its device."""
        if self.mesh is None:
            return {"device": self.device}
        return {"mesh": self.mesh, "data_axis": self.data_axis, "model_axis": self.model_axis}

    def devices(self) -> list[torch.device]:
        """The distinct devices the session's device miners run on (raises,
        as the miners do, when CUDA is bound and absent)."""
        if self.mesh is not None:
            return self.mesh.distinct_devices()
        return [resolve_device(self.device)]

    @property
    def miners_built(self) -> int:
        """Device-level miners built so far (resident-miner warmth metric)."""
        return sum(getattr(fe, "miners_built", 0) for fe in self._frontends.values())

    def submit(self, rows, n_items: int, spec: MineSpec) -> MineResult:
        """Mine one database through the session's resident frontends.

        hprepost requests route through the persistent PreparedDB cache
        (and, when bound, the snapshot store): back-to-back submits on the
        same database re-run zero prep stages (the second answer carries
        ``prep_shared`` and 0.0 prep times)."""
        with trace.span("engine.submit"):
            with self._lock:
                self.stats["submits"] += 1
            if spec.algorithm == "hprepost" and self.prep_cache_bytes > 0:
                return self._submit_cached(rows, n_items, spec)
            res = self.frontend(spec.algorithm).mine(rows, n_items, spec)
            self._observe_result(res)
            return res

    def _observe_result(self, res: MineResult) -> None:
        """Record one answered request into the latency registry. Totals
        stay in ``stats``/``cache_info``; these are the distributions."""
        t = self.telemetry
        t.histogram("engine.mine_s").record(res.wall_time_s)
        for k in _STAGE_KEYS:
            v = res.stage_times_s.get(k, 0.0)
            if v > 0.0:
                t.histogram(f"engine.stage.{k}_s").record(v)

    # --------------------------------------------------------- fingerprints
    @staticmethod
    def _digest(arr: np.ndarray) -> tuple:
        """Content identity of a database (planning must never share prep
        across different data, whatever object carries it)."""
        arr = np.ascontiguousarray(arr)
        # the reference's digest of ``arr.tobytes()``, hashed in place: the
        # rows are not copied first
        digest = hashlib.sha1(memoryview(arr).cast("B") if arr.size else b"").hexdigest()
        return (arr.shape, str(arr.dtype), digest)

    @staticmethod
    def _sample_digest(arr: np.ndarray) -> str:
        """Stride-sampled content digest — the cheap guard re-checked on
        every memo hit. Hashes at most ~64KiB of the array's bytes (every
        byte for arrays at or under that size, so the guard is exact
        there), keeping hit-path cost O(1)-ish while making a mutation
        that slips past it require every changed byte to fall between
        sample strides. Requires a C-contiguous array; the memo only
        admits those."""
        buf = arr.view(np.uint8).reshape(-1)
        step = max(1, buf.size // 65536)
        return hashlib.sha1(buf[::step].tobytes()).hexdigest()

    def _fingerprint(self, rows) -> tuple:
        """``_digest`` memoized per array object for the engine's lifetime,
        so hot-path submits on a resident database skip the O(R·L) hash.

        The memo key is object identity guarded by a weakref: a collected
        array (whose id may be recycled by a new allocation) can never
        return a stale fingerprint, because the dead/reseated weakref fails
        the identity check and the digest is recomputed.

        In-place mutation cannot slip a stale fingerprint through either:
        an array is only memoized while it is READ-ONLY. A writeable
        owning array is frozen (``setflags(write=False)``) on first
        memoization — direct mutation then raises at the caller's site,
        and the sanctioned mutation routes (``setflags(write=True)``, or
        ``invalidate_fingerprints`` which also restores writeability) both
        auto-invalidate: a memo entry whose array has become writeable
        again fails the hit check and is re-hashed. Views (``arr.base`` is
        not None) are never memoized — their content can change through
        the base without this array's flags moving.

        The one route the flags cannot police — a WRITEABLE VIEW taken
        *before* the submit keeps its own writeable flag (NumPy does not
        propagate ``setflags`` to existing views), so writing through it
        mutates the frozen base without tripping anything — is guarded by
        a stride-sampled digest (``_sample_digest``) re-verified on every
        hit: a mismatch drops the entry and re-hashes in full. The guard
        is exact for arrays <= 64KiB and probabilistic above (a mutation
        confined entirely to unsampled bytes passes); callers wanting a
        hard guarantee still use the sanctioned routes above."""
        with trace.span("engine.fingerprint"):
            arr = np.asarray(rows)
            with self._lock:
                memo = self._fp_memo.get(id(arr))
            was_frozen = False
            if memo is not None and memo[0]() is arr:
                if not arr.flags.writeable:
                    if self._sample_digest(arr) == memo[3]:
                        return memo[1]
                    # mutated through a pre-existing writeable view: the
                    # entry is stale even though the flags never moved.
                    # Remember that the memo froze this array so the fresh
                    # entry still thaws it on invalidation.
                    was_frozen = memo[2]
                # else: caller unfroze to mutate — auto-invalidate
                with self._lock:
                    self._fp_memo.pop(id(arr), None)
            fp = self._digest(arr)
            if arr.base is not None:
                return fp  # view: base mutation is invisible here — no memo
            if not arr.flags.c_contiguous:
                return fp  # sample guard needs a flat byte view — no memo
            try:
                ref = weakref.ref(arr)
            except TypeError:
                return fp  # not weakref-able: correctness first, no memo
            frozen = was_frozen
            if arr.flags.writeable:
                try:
                    arr.setflags(write=False)
                    frozen = True
                except ValueError:
                    return fp  # cannot freeze: mutation undetectable — no memo
            sample = self._sample_digest(arr)
            with self._lock:
                if len(self._fp_memo) >= self._fp_sweep_at:  # drop dead entries
                    self._fp_memo = {
                        k: v for k, v in self._fp_memo.items() if v[0]() is not None
                    }
                    # all-live memos (many resident DBs) must not re-sweep on
                    # every insert: back off to double the surviving size
                    self._fp_sweep_at = max(1024, 2 * len(self._fp_memo))
                self._fp_memo[id(arr)] = (ref, fp, frozen, sample)
            return fp

    def invalidate_fingerprints(self, rows=None) -> None:
        """Forget memoized fingerprints — all of them, or just ``rows`` —
        restoring writeability on arrays the memo froze.

        The convenience route for callers that want to mutate a submitted
        array in place (the raw route is ``rows.setflags(write=True)``,
        which the memo also treats as invalidation). Note this drops the
        *fingerprint* memo only; cached PreparedDB entries are keyed by
        content and stay valid."""
        def _thaw(entry):
            arr = entry[0]()
            if entry[2] and arr is not None:
                try:
                    arr.setflags(write=True)
                except ValueError:
                    pass
        with self._lock:
            if rows is None:
                for entry in self._fp_memo.values():
                    _thaw(entry)
                self._fp_memo.clear()
            else:
                entry = self._fp_memo.pop(id(np.asarray(rows)), None)
                if entry is not None:
                    _thaw(entry)

    # ------------------------------------------------ PreparedDB LRU cache
    def cache_info(self) -> dict:
        """Counters + occupancy of the persistent PreparedDB cache (and the
        snapshot store, when one is bound)."""
        with self._lock:
            info = {
                **self._cache_stats,
                "entries": len(self._prep_cache),
                "bytes_in_use": sum(
                    p.prep_bytes for _, p in self._prep_cache.values()
                ),
                "byte_budget": self.prep_cache_bytes,
            }
        if self.snapshot_store is not None:
            info["snapshot_store"] = self.snapshot_store.info()
        return info

    def clear_prep_cache(self) -> None:
        """Drop every in-memory PreparedDB (the LRU only — the snapshot
        store and the fingerprint memo are untouched). Simulates a process
        restart for warm-start benches/tests, or frees device memory."""
        with self._lock:
            self._prep_cache.clear()

    def _cache_key(self, rows, n_items: int, spec: MineSpec) -> tuple:
        # keyed on the *prep* config — execution-only knobs (la_block,
        # backend, early_stop, tune) are normalized away, so a retune or
        # backend switch keeps hitting warm PreparedDBs and snapshots
        fe = self.frontend("hprepost")
        return (spec.algorithm, self._fingerprint(rows), n_items, fe._prep_config(spec))

    def _store_key(self, key: tuple, miner) -> str:
        """The on-disk identity of ``key``: the LRU key plus the data-shard
        count the prep is laid out for (always 1 here; the reference's D=2
        snapshots cannot serve this miner — see ``PreparedDB.from_host``)."""
        algorithm, fp, n_items, cfg = key
        return SnapshotStore.key_for(algorithm, fp, n_items, cfg, miner.D)

    def _cache_lookup(self, key, min_count: int, need_waves: bool):
        """``(miner, prepared)`` if the cached entry can serve, else None.

        A floor-``f`` entry serves any ``min_count >= f`` exactly (see
        ``PreparedDB``); a looser request — or a k>1 request against an
        F1-only entry — cannot be served and must rebuild."""
        with self._lock:
            ent = self._prep_cache.get(key)
            if ent is None:
                self._cache_stats["misses"] += 1
                return None
            _, prepared = ent
            if min_count < prepared.min_count_floor or (need_waves and prepared.f1_only):
                self._cache_stats["misses"] += 1
                return None
            self._prep_cache.move_to_end(key)
            self._cache_stats["hits"] += 1
            return ent

    def _cache_insert(self, key, miner, prepared, *, spill: bool = True) -> None:
        """Insert (replacing any stale entry), then evict least-recently-
        used entries until the byte budget holds — possibly including the
        new entry itself when it alone exceeds the budget.

        Exception: a cheap F1-only build never replaces a full
        (waves-capable) entry at the same key — the wave state (Job 2 /
        pack / F2) is the expensive part, it keeps serving future k>1
        traffic, and F1-only prep costs one histogram to redo.

        With a snapshot store bound, the entry is also spilled to disk
        (``spill=False`` for entries that just came *from* the store)."""
        if self.prep_cache_bytes <= 0:
            return
        with self._lock:
            old = self._prep_cache.get(key)
            if old is not None and prepared.f1_only and not old[1].f1_only:
                return
            self._prep_cache.pop(key, None)
            self._prep_cache[key] = (miner, prepared)
            in_use = sum(p.prep_bytes for _, p in self._prep_cache.values())
            while in_use > self.prep_cache_bytes and self._prep_cache:
                _, (_, dropped) = self._prep_cache.popitem(last=False)
                in_use -= dropped.prep_bytes
                self._cache_stats["evictions"] += 1
        if spill and self.snapshot_store is not None:
            # outside the lock: device->host gather + disk write are slow,
            # and the store rejects writes that would not improve the entry.
            # Spilling is best-effort: a full/readonly disk (or a lost
            # cross-process publish race) must never fail the mining
            # request that just built a perfectly good PreparedDB
            try:
                self.snapshot_store.put(self._store_key(key, miner), prepared.to_host())
            except Exception:
                with self._lock:
                    self._cache_stats["snapshot_spill_failures"] += 1

    def _snapshot_load(self, key, min_count: int, need_waves: bool, spec: MineSpec):
        """Warm-start ``(miner, prepared)`` from the snapshot store, else
        None. A usable snapshot lands in the LRU (without re-spilling)."""
        if self.snapshot_store is None:
            return None
        from repro_torch.core.hprepost import PreparedDB

        fe = self.frontend("hprepost")
        miner = fe.miner_for(spec)
        try:
            payload = self.snapshot_store.get(self._store_key(key, miner))
        except Exception:  # a store I/O failure is a miss, never an error
            payload = None
        prepared = None
        if payload is not None:
            try:
                floor = int(payload["min_count_floor"])
                if min_count >= floor and not (need_waves and bool(payload["f1_only"])):
                    prepared = PreparedDB.from_host(payload, miner)
            except (ValueError, KeyError, TypeError):
                prepared = None  # unusable payload == miss; prep will heal it
        if prepared is None:
            with self._lock:
                self._cache_stats["snapshot_misses"] += 1
            return None
        self._cache_insert(key, miner, prepared, spill=False)
        with self._lock:
            self._cache_stats["snapshot_hits"] += 1
        return (miner, prepared)

    def _submit_cached(self, rows, n_items: int, spec: MineSpec) -> MineResult:
        fe = self.frontend("hprepost")
        rows = np.asarray(rows)
        key = self._cache_key(rows, n_items, spec)
        min_count = spec.resolve(len(rows))
        need_waves = spec.max_k is None or spec.max_k > 1
        t_lk = time.perf_counter()
        with trace.span("engine.cache"):
            ent = self._cache_lookup(key, min_count, need_waves)
            source = "cache"
            if ent is None:
                ent = self._snapshot_load(key, min_count, need_waves, spec)
                source = "snapshot"
        if ent is not None:
            self.telemetry.histogram(f"engine.{source}_hit_s").record(
                time.perf_counter() - t_lk
            )
            with self._lock:
                self.stats["prepared_mines"] += 1
            _, prepared = ent
            # mine with the *current* spec's miner, not the one that built
            # the entry: cache keys span execution configs, and the
            # PreparedDB layout only depends on the mesh (engine-wide)
            res = fe.mine_prepared(fe.miner_for(spec), prepared, spec, prep_shared=True)
            res.service_stats["prep_source"] = source
            self._observe_result(res)
            return res
        t0 = time.perf_counter()
        miner, prepared = fe.prepare(rows, n_items, min_count, spec,
                                     need_waves=need_waves)
        self.telemetry.histogram("engine.prep_s").record(time.perf_counter() - t0)
        self._cache_insert(key, miner, prepared)
        res = fe.mine_prepared(
            miner, prepared, spec, prep_stages=prepared.stage_times, t0=t0
        )
        res.service_stats["prep_source"] = "built"
        self._observe_result(res)
        return res

    # ------------------------------------------------------------ streaming
    def stream(self, name: str = "default", *, n_items: int | None = None,
               spec: MineSpec | None = None, stream_spec=None):
        """The named ``StreamingMiner``, created on first touch (creation
        needs ``n_items``; ``spec`` fixes its device config, ``stream_spec``
        its segmentation/compaction knobs). Segments warm-start from the
        engine's snapshot store when one is bound."""
        from repro_torch.mining.stream import StreamingMiner

        with self._lock:
            s = self._streams.get(name)
            if s is None:
                if n_items is None:
                    raise ValueError(
                        f"stream {name!r} does not exist yet; pass n_items to create it"
                    )
                s = StreamingMiner(
                    self, n_items, spec=spec, stream_spec=stream_spec, name=name
                )
                self._streams[name] = s
            elif n_items is not None and n_items != s.n_items:
                raise ValueError(
                    f"stream {name!r} was created with n_items={s.n_items}, got {n_items}"
                )
            return s

    def distribute(self, name: str = "default", *, n_items: int | None = None,
                   workers: int = 2, spec: MineSpec | None = None,
                   stream_spec=None, snapshot_dir: str | None = None,
                   heartbeat_s: float = 0.0, **kw):
        """The named ``DistributedMiner`` (coordinator + ``workers`` spawned
        worker processes), created on first touch. It registers under the
        same namespace as ``stream``, so ``engine.append`` /
        ``engine.submit_stream`` — and therefore the ``MiningService``
        submit path — serve distributed databases unchanged. Workers share
        the engine's snapshot directory by default (the failover warm
        path); pass ``snapshot_dir`` to point them elsewhere. On a CUDA
        engine worker ``wid`` binds ``cuda:{wid % torch.cuda.device_count()}``,
        else the engine's device."""
        from repro_torch.mining.distributed import DistributedMiner

        with self._lock:
            s = self._streams.get(name)
            if s is None:
                if n_items is None:
                    raise ValueError(
                        f"distributed db {name!r} does not exist yet; "
                        "pass n_items to create it"
                    )
                s = DistributedMiner(
                    self, n_items, workers=workers, spec=spec,
                    stream_spec=stream_spec, snapshot_dir=snapshot_dir,
                    heartbeat_s=heartbeat_s, name=name, **kw
                )
                self._streams[name] = s
            elif n_items is not None and n_items != s.n_items:
                raise ValueError(
                    f"stream {name!r} was created with n_items={s.n_items}, got {n_items}"
                )
            return s

    def append(self, rows, n_items: int | None = None, *, stream: str = "default",
               spec: MineSpec | None = None, stream_spec=None) -> dict:
        """Ingest one transaction batch into the named stream (the map
        step runs on the new batch only — earlier segments are never
        re-prepared). Returns per-append telemetry."""
        return self.stream(
            stream, n_items=n_items, spec=spec, stream_spec=stream_spec
        ).append(rows)

    def submit_stream(self, spec: MineSpec, *, stream: str = "default") -> MineResult:
        """Mine the named stream's live ``SegmentedDB`` (global F1/F2 from
        summed per-segment counts, cross-segment waves)."""
        with self._lock:
            s = self._streams.get(stream)
            if s is None:
                raise KeyError(f"no stream named {stream!r}; engine.append(...) first")
            self.stats["submits"] += 1
        return s.mine(spec)

    def register_standing(self, spec: MineSpec, *, stream: str = "default"):
        """Register a standing query on the named stream: mined once now,
        then re-answered with a ``MineDiff`` after every append/expiry.
        Returns the ``StandingQuery`` handle (``latest``, ``diffs``,
        ``next_diff() -> Future``). Works on streaming and distributed
        databases alike."""
        with self._lock:
            s = self._streams.get(stream)
            if s is None:
                raise KeyError(f"no stream named {stream!r}; engine.append(...) first")
        return s.register(spec)

    def cancel_standing(self, query, *, stream: str = "default") -> None:
        """Cancel a standing query returned by ``register_standing``."""
        with self._lock:
            s = self._streams.get(stream)
            if s is None:
                raise KeyError(f"no stream named {stream!r}")
        s.cancel(query)

    def stream_stats(self) -> dict:
        """Per-stream telemetry snapshot: ``{name: stats_dict}`` for every
        live streaming/distributed database (operator surface — the
        distributed dicts carry rpc_retries / respawns / failovers)."""
        with self._lock:
            streams = dict(self._streams)
        out = {}
        for name, s in streams.items():
            stats = getattr(s, "stats", None)
            if isinstance(stats, dict):
                out[name] = dict(stats)
        return out

    # ------------------------------------------------------ planned batches
    def _plan_key(self, req: MineRequest):
        """Group key for shared-prep planning, or None for the one-shot path.

        Only the hprepost backend has a prepare/mine split; a
        group must agree on the database and on every prep-level knob
        (the per-call threshold / max_k / patterns — and the execution-only
        kernel knobs — are free to differ). The key doubles as the
        persistent PreparedDB cache key."""
        if req.spec.algorithm != "hprepost":
            return None
        return self._cache_key(req.rows, req.n_items, req.spec)

    def _group_acquire(self, reqs: list[MineRequest], key: tuple):
        """Acquire the group's PreparedDB: ``(miner, prepared, source,
        prep_s)`` with source "cache" | "snapshot" | "built" and ``prep_s``
        the prepare wall seconds actually paid (None unless built).

        This is the (possibly expensive) prepare half of serving a planned
        group, split from the waves so a serving layer can run it on a prep
        thread while an earlier group's wave loop is still draining. Raises the
        prepare ``ValueError`` when the group floor trips a guard — the
        caller degrades to per-request submits."""
        failures.fire("service.prep")  # chaos: prep-thread death mid-acquire
        fe = self.frontend("hprepost")
        rows = np.asarray(reqs[0].rows)
        n_rows = len(rows)
        floor = min(r.spec.resolve(n_rows) for r in reqs)
        need_waves = any(r.spec.max_k is None or r.spec.max_k > 1 for r in reqs)
        if self.prep_cache_bytes > 0:
            t_lk = time.perf_counter()
            ent = self._cache_lookup(key, floor, need_waves)
            if ent is not None:
                self.telemetry.histogram("engine.cache_hit_s").record(
                    time.perf_counter() - t_lk
                )
                return (*ent, "cache", None)
            ent = self._snapshot_load(key, floor, need_waves, reqs[0].spec)
            if ent is not None:
                self.telemetry.histogram("engine.snapshot_hit_s").record(
                    time.perf_counter() - t_lk
                )
                return (*ent, "snapshot", None)
        t0 = time.perf_counter()
        miner, prepared = fe.prepare(
            rows, reqs[0].n_items, floor, reqs[0].spec, need_waves=need_waves
        )
        prep_s = time.perf_counter() - t0
        self.telemetry.histogram("engine.prep_s").record(prep_s)
        with self._lock:
            self.stats["prepares"] += 1
        self._cache_insert(key, miner, prepared)
        return miner, prepared, "built", prep_s

    def _group_serve(self, reqs: list[MineRequest], acq) -> list[MineResult]:
        """The k>2 waves per request of one planned group, over an acquired
        PreparedDB. On a "built" acquire the first request pays (and
        reports) the shared prep; every other consumer carries 0.0 prep
        stages and ``prep_shared``.

        The payer's wall time is reconstructed as prep work + its own
        waves: when the acquire ran ahead on a prep thread, the idle gap
        between prepare finishing and the group being served is scheduling
        delay, not work, and must not inflate ``wall_time_s``."""
        _, prepared, source, prep_s = acq
        fe = self.frontend("hprepost")
        out = []
        for j, r in enumerate(reqs):
            with self._lock:
                self.stats["submits"] += 1
                self.stats["prepared_mines"] += 1
            payer = source == "built" and j == 0
            res = fe.mine_prepared(
                fe.miner_for(r.spec), prepared, r.spec,
                prep_stages=prepared.stage_times if payer else None,
                prep_shared=not payer,
                t0=time.perf_counter() - prep_s if payer else None,
            )
            res.service_stats["prep_source"] = source
            self._observe_result(res)
            out.append(res)
        return out

    def _run_group(self, reqs: list[MineRequest], key: tuple) -> list[MineResult]:
        """Serve one planned group: acquire the PreparedDB (cache / snapshot
        / one build at the loosest threshold), then the waves per request."""
        try:
            acq = self._group_acquire(reqs, key)
        except ValueError:
            # the floor F-list can trip guards (max_f1) that tighter
            # thresholds in the group would individually pass; don't fail
            # the whole batch — degrade to the one-shot path per request,
            # where any real per-request error surfaces precisely
            return [self.submit(r.rows, r.n_items, r.spec) for r in reqs]
        return self._group_serve(reqs, acq)

    def submit_many(self, requests: Iterable[MineRequest]) -> list[MineResult]:
        """Serve a batch of requests; results align with the input order.

        Requests that share (database, device config) on the hprepost
        backend are planned together — one PreparedDB at the group's
        loosest threshold serves all of them. Everything else (host
        algorithms, singleton groups) takes the one-shot path; frontends
        stay warm across the whole batch either way."""
        requests = list(requests)
        results: list[MineResult | None] = [None] * len(requests)
        groups: dict[tuple, list[int]] = {}
        loners: list[int] = []
        for i, r in enumerate(requests):
            key = self._plan_key(r)
            if key is None:
                loners.append(i)
            else:
                groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            if len(idxs) == 1:
                loners.append(idxs[0])
                continue
            for i, res in zip(idxs, self._run_group([requests[i] for i in idxs], key)):
                results[i] = res
        for i in sorted(loners):
            r = requests[i]
            results[i] = self.submit(r.rows, r.n_items, r.spec)
        return results

    def sweep(self, rows, n_items: int, spec: MineSpec,
              min_sups: Sequence[float]) -> list[MineResult]:
        """Threshold sweep (the paper's x-axis) on one warm miner.

        For hprepost the sweep is planned: Job 1 / Job 2 / pack / F2 run
        once at the loosest threshold and every ``min_sup`` is served from
        the shared PreparedDB — results are itemset-identical to
        independent ``submit`` calls per threshold."""
        return self.submit_many(
            [MineRequest(rows, n_items, spec.with_(min_sup=s)) for s in min_sups]
        )
