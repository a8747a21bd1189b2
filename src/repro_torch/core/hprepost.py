"""HPrepost on one torch device: the paper's MapReduce miner.

The Hadoop pipeline maps onto one data shard and one candidate group
(the reference's 1×1 mesh):

  Job 1 (word count)      -> histogram kernel over the rows
  Job 2 map (F-list sort) -> ``rank_encode_torch``
  Job 2 reduce (PPC-tree) -> sort-based ``build_ppc_torch``, then the N-list
                             pack into a ``(D=1, K, W, 3)`` buffer
  F2 scan                 -> co-occurrence kernel
  k>2 mining waves        -> batched N-list intersections: the fused
                             intersect + support kernel, reading each
                             candidate's parent state and N-lists by index

The streaming reduce (``mine_prepared_segments``) runs the same wave loop
over a segmented database: one B1 launch per segment per wave, against
each segment's ``(3, K_s + 1, W_s)`` planes (``extend_with_sentinel``), and
the per-segment supports summed on the host.

Mining state per candidate: the merged N-list counts aligned with the
candidate's base-item code slots — ``(C, W)`` buffers, candidate counts
bucketed to powers of two like the reference. The host drives the level
loop (as the Hadoop job tracker does) with the reference's NumPy planning,
and keeps one wave in flight: wave l+1 is dispatched before wave l's
supports are read back (through a pinned buffer and an event, so the read
waits for wave l alone).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core import encoding as enc
from repro_torch.core.ppc import build_ppc_torch
from repro_torch.core.prepost import PrepostResult
from repro_torch.device import resolve_device
from repro_torch.fault import failures
from repro_torch.kernels.cooccur.ops import cooccurrence_matrix
from repro_torch.kernels.histogram.ops import item_histogram
from repro_torch.kernels.nlist_intersect.ops import EXACT_MAX, nlist_wave
from repro_torch.mining import tune
from repro_torch.mining.telemetry import trace

INF32 = np.iinfo(np.int32).max

# Version tag of the PreparedDB host payload (``to_host``/``from_host``),
# the same layout as the reference's. Bump on any layout change so stale
# on-disk snapshots are rejected, not misread.
PREPARED_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class HPrepostConfig:
    max_k: int | None = None
    nlist_width: int | None = None  # static W; None = auto (next pow2 of max)
    candidate_unit: int = 256  # candidate buffers: pow2 multiples of this
    la_block: int = 512  # early-stop kernel: A-codes per liveness tile
    pipeline_waves: bool = True  # dispatch wave l+1 before blocking on wave
    # l's supports: host candidate generation overlaps device execution; the
    # one-wave speculation is sound because support is anti-monotone
    backend: str = "auto"  # a repro_torch.mining.tune registry name
    # (auto | cuda | torch)
    max_f1: int = 4096  # guard on |F-list| (F2 matrix is K^2)
    max_itemsets: int = 2_000_000
    early_stop: bool = True  # early-stopping intersections (arXiv:1901.07773):
    # host-side Apriori-closure pruning of doomed candidates before they ship,
    # plus in-kernel bound masking (the masked twin kernel). False = the
    # exact legacy path, bit-for-bit.
    tune: bool = False  # resolve la_block through the persisted KernelTuner
    # instead of the static field

    # knobs that pick *how* waves execute but never change what ``prepare``
    # builds — stripped (normalized to defaults) from prep cache and
    # snapshot keys so a retune or backend switch reuses warm preps
    EXECUTION_ONLY = ("la_block", "backend", "early_stop", "tune")

    def prep_key(self) -> "HPrepostConfig":
        """This config with execution-only knobs normalized away — the
        identity ``PreparedDB`` caches and snapshots key on."""
        defaults = {f: getattr(HPrepostConfig, f) for f in self.EXECUTION_ONLY}
        return dataclasses.replace(self, **defaults)


@dataclasses.dataclass
class PreparedDB:
    """Threshold-floor prepared database: every stage that depends only on
    the *loosest* threshold of a sweep (Job 1 histogram/F-list, Job 2
    PPC-tree build, N-list pack, F2 scan), device-resident.

    ``mine_prepared`` serves any ``min_count >= min_count_floor`` from it:
    the floor F-list is a superset of every tighter F-list, and N-list
    intersections count exact database supports regardless of which extra
    items sit in the tree, so tighter thresholds only *filter* — they never
    need a rebuild.
    """

    fl: enc.FList  # built at min_count_floor (superset of tighter F-lists)
    n_items: int
    n_rows: int  # unpadded R0 the thresholds resolve against
    min_count_floor: int  # loosest threshold this prep can serve
    width: int  # static N-list width W (0 when F1-only)
    packed: Any  # (1, K, W, 3) int32 device N-lists, or None when F1-only
    C: np.ndarray  # (K, K) upper-triangular F2 co-occurrence counts
    prep_bytes: int  # footprint: rows + F-list + packed
    rows_flist_bytes: int  # the threshold-independent part of prep_bytes
    stage_times: dict[str, float]  # job1_flist / job2_ppc_pack / f2_scan
    f1_only: bool = False  # True when built with need_waves=False
    n_shards: int = 1  # data-shard count (D) this prep was laid out for
    # False when the F-list order was imposed externally (``prepare(...,
    # flist=...)`` — the streaming path's shared global item order) instead
    # of derived support-descending from this database. Such preps are
    # segment building blocks for ``mine_prepared_segments``; the prefix
    # arithmetic ``mine_prepared`` leans on does not hold for them.
    support_ordered: bool = True

    def to_host(self) -> dict:
        """The prep as a host payload (plain numpy + scalars) in the
        reference's layout: ``packed`` keeps its ``(D, K, W, 3)`` shape."""
        out = {
            "schema": PREPARED_SCHEMA,
            "n_items": int(self.n_items),
            "n_rows": int(self.n_rows),
            "min_count_floor": int(self.min_count_floor),
            "width": int(self.width),
            "f1_only": bool(self.f1_only),
            "support_ordered": bool(self.support_ordered),
            "n_shards": int(self.n_shards),
            "prep_bytes": int(self.prep_bytes),
            "rows_flist_bytes": int(self.rows_flist_bytes),
            "fl_min_count": int(self.fl.min_count),
            "fl_items": np.asarray(self.fl.items),
            "fl_supports": np.asarray(self.fl.supports),
            "C": np.asarray(self.C),
        }
        if self.packed is not None:
            out["packed"] = self.packed.cpu().numpy()
        return out

    @classmethod
    def from_host(cls, payload: dict, miner: "HPrepostMiner") -> "PreparedDB":
        """Load a ``to_host`` payload onto ``miner``'s device.

        Raises ``ValueError`` when the payload cannot serve here (schema
        skew, data-shard count mismatch, or shape corruption). Prep stage
        times come back zeroed: a warm start pays no prep."""
        try:
            if int(payload["schema"]) != PREPARED_SCHEMA:
                raise ValueError(f"PreparedDB snapshot schema {payload['schema']!r} "
                                 f"!= {PREPARED_SCHEMA}")
            n_shards = int(payload["n_shards"])
            if n_shards != miner.D:
                raise ValueError(
                    f"snapshot was prepared for {n_shards} data shard(s) but the "
                    f"miner has D={miner.D}; per-shard PPC state does not re-shard "
                    f"— re-prepare"
                )
            fl = enc.FList(
                items=np.asarray(payload["fl_items"], np.int32),
                supports=np.asarray(payload["fl_supports"], np.int64),
                n_items=int(payload["n_items"]),
                min_count=int(payload["fl_min_count"]),
            )
            width = int(payload["width"])
            f1_only = bool(payload["f1_only"])
            C = np.asarray(payload["C"], np.int64)
            if C.shape != (fl.k, fl.k):
                raise ValueError(f"snapshot C has shape {C.shape}, expected {(fl.k, fl.k)}")
            packed = None
            if not f1_only and fl.k > 0:
                ph = np.asarray(payload["packed"], np.int32)
                want = (n_shards, fl.k, width, 3)
                if ph.shape != want:
                    raise ValueError(f"snapshot packed has shape {ph.shape}, expected {want}")
                packed = torch.from_numpy(np.array(ph)).to(miner.device)
        except (KeyError, TypeError, OverflowError) as e:
            raise ValueError(f"malformed PreparedDB snapshot payload: {e!r}") from e
        return cls(
            fl=fl,
            n_items=int(payload["n_items"]),
            n_rows=int(payload["n_rows"]),
            min_count_floor=int(payload["min_count_floor"]),
            width=width,
            packed=packed,
            C=C,
            prep_bytes=int(payload["prep_bytes"]),
            rows_flist_bytes=int(payload["rows_flist_bytes"]),
            stage_times={"job1_flist": 0.0, "job2_ppc_pack": 0.0, "f2_scan": 0.0},
            f1_only=f1_only,
            n_shards=n_shards,
            support_ordered=bool(payload.get("support_ordered", True)),
        )

    def bytes_at(self, min_count: int, n_shards: int) -> int:
        """Prep footprint attributable to one threshold: rows + F-list + the
        N-list prefix of ranks frequent at ``min_count`` (the floor F-list
        is support-descending, so that prefix is exactly what an
        independent mine at this threshold would pack)."""
        packed_part = 0
        if self.packed is not None:
            packed_part = int(self.k_active(min_count) * self.width * 3 * 4 // max(n_shards, 1))
        return self.rows_flist_bytes + packed_part

    def k_active(self, min_count: int) -> int:
        """|F1| at ``min_count`` — a prefix length of the floor F-list."""
        return int(np.count_nonzero(np.asarray(self.fl.supports) >= min_count))


@dataclasses.dataclass
class SegmentHandle:
    """One segment's device state, ready for cross-segment wave execution.

    ``planes`` are the segment's N-lists as the wave kernel reads them,
    ``(3, K_s + 1, W_s)`` int32 (pre, post, count), with one all-padding
    *sentinel* rank row at index ``K_s`` (``extend_with_sentinel``); ``g2l``
    maps every global stream rank to the segment's local rank, with ranks
    absent from the segment mapped to the sentinel. The wave kernel cuts
    every list at its padding, so the sentinel row is an empty N-list: a
    candidate touching an item the segment never saw reports support 0
    there — precisely its contribution to the global (additive) support.
    (The reference's handle holds the same rows as a ``(D, K_s + 1, W_s,
    3)`` buffer.)

    ``ready``: a CUDA event recorded after the planes were built, when they
    were built on another stream than the queries' (a compaction's); None
    otherwise."""

    planes: Any  # (3, K_s + 1, W_s) device N-lists incl. the sentinel row
    singleton: Any  # planes[2] — the segment's level-2 bootstrap
    g2l: np.ndarray  # (K_global,) int32: stream rank -> local rank | K_s
    ready: Any = None


class LocalSegmentExecutor:
    """Runs planned waves over in-process segment handles — the execution
    half of ``mine_prepared_segments``, split from the planning loop so a
    coordinator can swap in a remote executor without touching the planner.

    Contract (the reference's, with the port's wave layout):

      - ``n_segments``: how many transaction partitions answer waves; 0
        short-circuits the wave loop (F1-only result).
      - ``begin()``: reset per-query state to the level-2 singleton
        bootstrap.
      - ``dispatch(level, idx, n_live)``: launch one planned wave over every
        segment; ``idx`` is the wave's host ``(3, Cpad)`` int64 (parent,
        base, extension) rows from ``HPrepostMiner._pack_wave`` in the
        global rank space, ``n_live`` its live slots. Returns an opaque
        token and does not block on device results (pipelining). No
        in-kernel early stop: segmented supports are partial until the
        cross-segment reduce, so masking against the global threshold
        would be unsound — every segment wave runs B1, and host-side
        pruning carries the early-stop win.
      - ``collect(token)``: block, and return the per-candidate supports
        summed over this executor's segments as an int64 host vector —
        the paper's reduce step. With ``weights`` the reduce is instead the
        float64 weighted sum ``Σ w_s · sup_s`` (time-decayed supports: the
        per-segment integer supports stay exact on the device; damping
        happens only in this host reduce).
      - ``weights``: optional per-segment float weights, or None for the
        exact integer reduce — the planner reads this attribute to decide
        integer vs float threshold semantics.
      - ``state_bytes``: footprint of the in-flight merged-N-list states
        after the latest dispatch/collect (peak accounting).
    """

    def __init__(self, miner: "HPrepostMiner", handles: "list[SegmentHandle]",
                 weights=None):
        self.miner = miner
        self.handles = list(handles)
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            if len(weights) != len(self.handles):
                raise ValueError(
                    f"{len(weights)} segment weights for {len(self.handles)} handles"
                )
        self.weights = weights
        self._prev: list | None = None
        self.state_bytes = 0

    @property
    def n_segments(self) -> int:
        return len(self.handles)

    def begin(self) -> None:
        dev = self.miner.device
        for h in self.handles:
            if h.ready is not None:
                # planes built on another stream (a compaction's): order
                # this query's stream after the build, and mark the planes in
                # use here so the allocator cannot hand their block out while
                # these waves still read it, whenever the segment is dropped
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(h.ready)
                h.planes.record_stream(stream)
        self._prev = [h.singleton for h in self.handles]
        self.state_bytes = 0

    def dispatch(self, level: int, idx: np.ndarray, n_live: int):
        m = self.miner
        failures.fire("mine.wave")
        new_states, parts = [], []
        for h, prev in zip(self.handles, self._prev):
            # level-2 parents are singleton ranks (per-segment rows); later
            # levels read the parent state by global slot, shared by layout
            local = np.stack([h.g2l[idx[0]] if level == 2 else idx[0],
                              h.g2l[idx[1]], h.g2l[idx[2]]]).astype(np.int64)
            new_s, sup_s = nlist_wave(
                h.planes, prev, _to_device(local, m.device), n_live,
                backend=m.backend, early_stop=False,
            )
            new_states.append(new_s)
            parts.append(sup_s)
        m.stage_counters["waves"] += 1
        m.stage_counters["seg_waves"] = (
            m.stage_counters.get("seg_waves", 0) + len(self.handles)
        )
        self._prev = new_states
        self.state_bytes = sum(int(s.numel() * 4) for s in new_states)
        # one device-to-host copy of every segment's supports, not S copies
        return _HostRead(torch.stack(parts))

    def collect(self, token) -> np.ndarray:
        stacked = token.get()
        if self.weights is not None:
            return np.tensordot(self.weights, stacked.astype(np.float64), axes=1)
        return np.sum(stacked, axis=0, dtype=np.int64)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pack_nlists_torch(item, count, pre, post, k: int, width: int) -> torch.Tensor:
    """Per-item N-lists of a pre-ordered node set -> ``(1, k, width, 3)``
    int32 ``(pre, post, count)``, padded ``(INT32_MAX, -1, 0)``; slots past
    ``width`` are dropped. A stable sort by item keeps pre order inside
    each item, as the reference's ``(item, pre)`` lexsort does."""
    dev = item.device
    order = torch.sort(item, stable=True).indices
    sitem = item[order]
    bounds = torch.searchsorted(sitem, torch.arange(k + 1, device=dev))
    slot = torch.arange(len(sitem), device=dev) - bounds[sitem]
    keep = slot < width
    flat = (sitem * width + slot)[keep]
    vals = torch.stack([pre[order], post[order], count[order]], dim=1)[keep]
    packed = torch.tensor([INF32, -1, 0], dtype=torch.int32, device=dev).repeat(k * width, 1)
    packed[flat] = vals.to(torch.int32)
    return packed.reshape(1, k, width, 3)


class _HostRead:
    """A device vector copied back without blocking the caller: on CUDA a
    non-blocking copy into pinned memory plus an event, so ``get`` waits for
    the work before the copy only — never for waves dispatched after it."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, read-only arrays included: the
    engine's fingerprint memo freezes the arrays it has hashed, and nothing
    here writes through the tensor."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class HPrepostMiner:
    """The N-list miner on one torch device (D = 1 data shard, M = 1
    candidate group). ``device`` defaults to CUDA and raises when none is
    present; pass ``device="cpu"`` for the plain PyTorch versions."""

    def __init__(self, device=None, config: HPrepostConfig = HPrepostConfig()):
        self.device = resolve_device(device)
        self.cfg = config
        self.D = 1  # data shards: one device holds the whole database
        self.last_stage_times: dict[str, float] = {}
        # how many times each device stage ran over this miner's lifetime —
        # the engine's shared-prep planning is asserted against these
        self.stage_counters: dict[str, int] = {
            "job1": 0, "job2": 0, "pack": 0, "f2": 0, "waves": 0
        }
        self.backend = tune.resolve_backend(config.backend, self.device.type)
        tune.check_backend(self.backend, torch.empty(0, device=self.device))
        # KernelPlan resolution: the owning frontend/engine attaches a
        # ``KernelTuner`` here; with ``cfg.tune`` off (or no tuner) plans
        # come straight from the config knobs. Memoized per wave shape.
        self.tuner = None
        self._plan_cache: dict[tuple[int, int], tune.KernelPlan] = {}

    def _kernel_plan(self, n_cands: int, width: int) -> tune.KernelPlan:
        """Resolve the execution plan (concrete backend + ``la_block``) for a
        wave of ``n_cands`` candidates over ``width``-slot N-lists."""
        key = (tune._bucket(n_cands, 8, 512), tune._bucket(width, 8, 1024))
        plan = self._plan_cache.get(key)
        if plan is None:
            cfg = self.cfg
            if cfg.tune and self.tuner is not None:
                plan = self.tuner.plan_for(
                    backend=cfg.backend, B=n_cands, W=width, early_stop=cfg.early_stop,
                )
            else:
                plan = tune.static_plan(
                    cfg.backend, cfg.la_block, cfg.early_stop, self.device.type,
                )
            self._plan_cache[key] = plan
        return plan

    # ---------------------------------------------------------------- prep
    def prepare(
        self, rows: np.ndarray, n_items: int, min_count_floor: int, *,
        need_waves: bool = True, flist: enc.FList | None = None,
    ) -> PreparedDB:
        """Run every threshold-floor stage once: Job 1 (histogram/F-list),
        Job 2 (PPC-tree), N-list pack, F2 scan. The result serves any
        ``mine_prepared`` at ``min_count >= min_count_floor``.

        ``need_waves=False`` stops after the F-list (for ``max_k == 1``
        traffic, where the tree/N-lists are never consulted).

        ``flist`` imposes an external item order instead of deriving it
        support-descending from this database — the streaming path's global
        stream order, which every segment must share so cross-segment
        N-list ancestor relations agree. Job 1 is skipped then (the caller
        already counted the batch, and no histogram kernel is launched),
        and the result is marked ``support_ordered=False``: it can only be
        mined through ``mine_prepared_segments``."""
        cfg = self.cfg
        dev = self.device
        stages: dict[str, float] = {}
        t0 = time.perf_counter()
        R0, L = rows.shape
        # the kernels accumulate counts in int32; every count they can
        # produce is bounded by the row count, so refuse what could wrap
        if self.backend == "cuda" and R0 >= EXACT_MAX:
            raise ValueError(
                f"row count {R0} reaches the int32 exact-integer bound 2^31-1 "
                f"of the CUDA kernels' counts"
            )
        rows_p = np.require(rows, np.int32, ["C"])
        rows_t = _host_tensor(rows_p).to(dev)

        if flist is None:
            hist = item_histogram(rows_t, n_bins=n_items, backend=cfg.backend)
            supports = hist.cpu().numpy()
            self.stage_counters["job1"] += 1
            fl = enc.build_flist(supports, min_count_floor)
        else:
            if flist.n_items != n_items:
                raise ValueError(
                    f"imposed flist covers {flist.n_items} items, database has {n_items}"
                )
            fl = flist
        stages["job1_flist"] = time.perf_counter() - t0
        K = fl.k
        if K > cfg.max_f1:
            raise ValueError(f"|F1|={K} exceeds max_f1={cfg.max_f1}; raise min_count or max_f1")

        rows_flist_bytes = int(rows_p.nbytes) + int(fl.items.nbytes + fl.supports.nbytes)
        prep_bytes = rows_flist_bytes
        stages["job2_ppc_pack"] = 0.0
        stages["f2_scan"] = 0.0
        packed = None
        C = np.zeros((K, K), np.int64)
        W = 0
        if K > 0 and need_waves:
            t0 = time.perf_counter()
            lut = torch.from_numpy(fl.rank_lut()).to(dev)
            ranked = enc.rank_encode_torch(rows_t, lut, n_items)
            w = torch.ones(R0, dtype=torch.int64, device=dev)
            item, count, pre, post = build_ppc_torch(ranked, w, K)
            self.stage_counters["job2"] += 1
            lens = torch.bincount(item, minlength=K)
            w_needed = max(int(lens.max()) if len(item) else 1, 1)
            W = cfg.nlist_width or _pow2(max(w_needed, 8))
            packed = pack_nlists_torch(item, count, pre, post, K, W)
            self.stage_counters["pack"] += 1
            stages["job2_ppc_pack"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            if K > 1:
                C = cooccurrence_matrix(ranked, n_items=K, backend=cfg.backend).cpu().numpy()
                self.stage_counters["f2"] += 1
            C = np.triu(C, 1)
            stages["f2_scan"] = time.perf_counter() - t0
            prep_bytes += int(packed.numel() * 4)

        return PreparedDB(
            fl=fl, n_items=n_items, n_rows=R0, min_count_floor=int(min_count_floor),
            width=W, packed=packed, C=C,
            prep_bytes=prep_bytes, rows_flist_bytes=rows_flist_bytes,
            stage_times=stages, f1_only=not need_waves, n_shards=self.D,
            support_ordered=flist is None,
        )

    # ---------------------------------------------------------------- waves
    def _pack_wave(self, ranks, parents, qarr):
        """Host slot assignment for one wave: candidate i -> device slot i,
        padded to a power-of-two multiple of ``candidate_unit``. (With one
        shard the reference's locality bucketing assigns the same slots.)
        Slots ``>= len(ranks)`` are padding: the wave kernel reads nothing
        for them and writes zeros.

        -> (idx (3, Cpad) int64 rows (parent, base, extension), slot_of, Cpad)."""
        unit = self.cfg.candidate_unit
        Cn = len(ranks)
        Cpad = unit * _pow2((Cn + unit - 1) // unit)
        slot_of = np.arange(Cn, dtype=np.int64)
        idx = np.zeros((3, Cpad), np.int64)
        idx[0, :Cn] = parents
        idx[1, :Cn] = ranks[:, 1]
        idx[2, :Cn] = qarr
        return idx, slot_of, Cpad

    def _wave(self, planes, prev_state, idx, n_live: int, stop_count: int):
        """One wave on the device: the fused intersect + support kernel reads
        each live candidate's parent state and N-lists in place by ``idx``
        — no gathered copies. Its plan comes per wave shape."""
        plan = self._kernel_plan(idx.shape[1], planes.shape[2])
        return nlist_wave(
            planes, prev_state, _to_device(idx, self.device), n_live, backend=plan.backend,
            la_block=plan.la_block, early_stop=plan.early_stop, min_count=stop_count,
        )

    @staticmethod
    def _extensions(ranks, slots, pair_packed, prefix_packed, k_items):
        """Candidate generation: extend each rank row with every rank
        ``q2 < ranks[0]`` whose pairs with all members are frequent.

        Vectorized over the whole wave: the per-candidate allowed set is the
        bitwise AND of the gathered bit-packed ``pair_ok`` rows of its
        members, masked by the packed strict-lower-triangle prefix row of
        its smallest rank — no per-candidate Python loop.

        -> (ranks', parents', q') with ranks' of width ``ranks.shape[1]+1``."""
        k = ranks.shape[1]
        if not len(ranks):
            return (np.empty((0, k + 1), np.int32), np.empty(0, np.int64),
                    np.empty(0, np.int32))
        allowed = np.bitwise_and.reduce(pair_packed[ranks], axis=1)  # (C, Kb)
        allowed &= prefix_packed[ranks[:, 0]]
        mask = np.unpackbits(allowed, axis=1, count=k_items).view(bool)
        cs, q2s = np.nonzero(mask)
        new_ranks = np.concatenate(
            [q2s[:, None].astype(np.int32), ranks[cs]], axis=1
        )
        return new_ranks, slots[cs], q2s.astype(np.int32)

    @staticmethod
    def _apriori_kept(d_ranks: np.ndarray, surv_ranks: np.ndarray):
        """Anti-monotone host bound, boolean form: a width-``l+1`` candidate
        can reach ``min_count`` only if *every* drop-one subset of width
        ``l`` survived the settled wave — the enumeration guarantees every
        frequent width-``l`` itemset is in ``surv_ranks``, so a missing
        subset proves the candidate doomed. Position 0 (the extension item)
        is the parent the caller already checked; pair subsets are implied
        by ``pair_ok`` — so this only bites from width 4 up, and returns
        None below that.

        Membership is vectorized by viewing C-contiguous int32 rank rows as
        fixed-width byte strings: at equal total width, numpy's trailing-
        NUL-stripping compare is still an exact row equality."""
        l1 = d_ranks.shape[1]
        if l1 < 4 or not len(d_ranks) or not len(surv_ranks):
            return None
        w = l1 - 1
        sv = np.ascontiguousarray(surv_ranks).view(f"S{4 * w}").ravel()
        kept = np.ones(len(d_ranks), bool)
        for pos in range(1, l1):
            sub = np.ascontiguousarray(
                np.concatenate([d_ranks[:, :pos], d_ranks[:, pos + 1:]], axis=1)
            )
            kept &= np.isin(sub.view(f"S{4 * w}").ravel(), sv)
            if not kept.any():
                break
        return kept

    def mine_prepared(
        self,
        prepared: PreparedDB,
        min_count: int,
        *,
        max_k: int | None | type(Ellipsis) = ...,
    ) -> PrepostResult:
        """The k>2 wave loop only, over a shared ``PreparedDB``. Any
        ``min_count >= prepared.min_count_floor`` is served exactly: floor
        structures are supersets, N-list supports are exact DB supports.

        With ``cfg.pipeline_waves`` the loop dispatches wave ``l+1`` before
        blocking on wave ``l``'s supports, so host candidate generation
        overlaps device execution. The one wave of speculation is sound:
        children of candidates that turn out infrequent report supports
        below ``min_count`` themselves (anti-monotonicity), so they can
        never be emitted; once the parent wave's supports arrive, the dead
        branches are pruned from further host enumeration.
        """
        cfg = self.cfg
        max_k = cfg.max_k if max_k is ... else max_k
        if not prepared.support_ordered:
            raise ValueError(
                "PreparedDB was built with an imposed (stream-order) F-list; "
                "its F-list is not a support-descending prefix structure — "
                "mine it through mine_prepared_segments"
            )
        if min_count < prepared.min_count_floor:
            raise ValueError(
                f"min_count={min_count} is looser than the PreparedDB floor "
                f"{prepared.min_count_floor}; re-prepare at the looser threshold"
            )
        fl = prepared.fl
        K = fl.k
        stages = self.last_stage_times = {
            "job1_flist": 0.0, "job2_ppc_pack": 0.0, "f2_scan": 0.0,
            "mining_waves": 0.0,
            # planning counters ride the stage dict into MineResult
            # stage_times_s: candidates shipped, and candidates the host
            # bound killed (dead parent / missing Apriori subset)
            "planned_candidates": 0.0,
            "host_pruned_parent": 0.0, "host_pruned_subset": 0.0,
        }
        itemsets: dict[tuple[int, ...], int] = {}
        k_act = prepared.k_active(min_count)
        items_arr = np.asarray(fl.items)
        for it, s in zip(
            items_arr[:k_act].tolist(), np.asarray(fl.supports)[:k_act].tolist()
        ):
            itemsets[(int(it),)] = int(s)
        flist_items = fl.items[:k_act]
        peak = prepared.bytes_at(min_count, self.D)
        if K == 0 or max_k == 1 or not itemsets:
            return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)
        if prepared.f1_only:
            raise ValueError(
                "PreparedDB was built with need_waves=False (F1 only); "
                "re-prepare with need_waves=True to mine k >= 2"
            )

        C = prepared.C
        pair_ok = (C + C.T) >= min_count
        # bit-packed planning tables for the vectorized _extensions:
        # pair_packed[r] is pair_ok's row r, prefix_packed[r] the strict
        # prefix mask {q2 : q2 < r} — both 8 ranks per byte
        pair_packed = np.packbits(pair_ok, axis=1)
        prefix_packed = np.packbits(np.tri(K, K, -1, dtype=bool), axis=1)
        # planar (3, K, W) copy of the N-lists: the wave kernel reads each
        # candidate's (pre, post, count) rows as contiguous W-wide rows
        planes = prepared.packed[0].permute(2, 0, 1).contiguous()
        prev_state = planes[2]  # level-2 parents: singleton counts, packed[0, ..., 2]
        qs, ps = np.nonzero(C >= min_count)
        ranks = np.stack([qs, ps], axis=1).astype(np.int32)  # (C, 2) ascending
        parents = ps.astype(np.int64)  # level-2 parents: singleton rank slots
        qarr = qs.astype(np.int32)
        level = 2
        pending = None  # (ranks, slot_of, supports read) of the wave in flight
        # in-kernel early stop is only sound where the kernel sees *final*
        # supports: one data shard, which this miner always is
        stop_count = min_count if cfg.early_stop else 0

        t0 = time.perf_counter()
        while len(ranks) or pending is not None:
            dispatched = None
            if len(ranks) and (max_k is None or level <= max_k) and len(itemsets) < cfg.max_itemsets:
                idx, slot_of, Cpad = self._pack_wave(ranks, parents, qarr)
                stages["planned_candidates"] += float(len(ranks))
                failures.fire("mine.wave")
                with trace.span("mine.wave", k=level, candidates=len(ranks)):
                    new_state, sups = self._wave(planes, prev_state, idx, len(ranks), stop_count)
                    read = _HostRead(sups)
                self.stage_counters["waves"] += 1
                dispatched = (ranks, parents, slot_of, read)
                peak = max(peak, int(new_state.numel() * 4))
                prev_state = new_state
                level += 1
            if not cfg.pipeline_waves and dispatched is not None:
                # degrade: block right away (no speculative wave in flight,
                # so the parent column is never consulted)
                pending = (dispatched[0], dispatched[2], dispatched[3])
                dispatched = None

            surv_mask = None  # boolean over the settled wave's device slots
            surv_ranks = surv_slots = None
            if pending is not None:
                p_ranks, p_slots, p_read = pending
                with trace.span("mine.reduce", k=level - 1):
                    host = p_read.get()  # blocks on wave l-1 only
                svals = host[p_slots]
                keep = svals >= min_count
                if keep.any():
                    emit_items = np.sort(items_arr[p_ranks[keep]], axis=1)
                    for t, s in zip(emit_items.tolist(), svals[keep].tolist()):
                        itemsets[tuple(t)] = int(s)
                surv_mask = np.zeros(host.shape[0], bool)
                surv_mask[p_slots[keep]] = True
                surv_ranks, surv_slots = p_ranks[keep], p_slots[keep]
                pending = None

            if dispatched is not None:
                d_ranks, d_parents, d_slot_of, d_read = dispatched
                if surv_mask is not None:
                    # speculative wave l was enumerated before wave l-1's
                    # supports arrived; drop children of dead parents from
                    # further enumeration (their own supports self-filter)
                    kept = surv_mask[d_parents]
                    stages["host_pruned_parent"] += float((~kept).sum())
                    d_ranks, d_slot_of = d_ranks[kept], d_slot_of[kept]
                    if cfg.early_stop:
                        sub = self._apriori_kept(d_ranks, surv_ranks)
                        if sub is not None:
                            stages["host_pruned_subset"] += float((~sub).sum())
                            d_ranks, d_slot_of = d_ranks[sub], d_slot_of[sub]
                pending = (d_ranks, d_slot_of, d_read)
                ranks, parents, qarr = self._extensions(
                    d_ranks, d_slot_of, pair_packed, prefix_packed, K
                )
            elif surv_mask is not None and not cfg.pipeline_waves:
                ranks, parents, qarr = self._extensions(
                    surv_ranks, surv_slots, pair_packed, prefix_packed, K
                )
                if cfg.early_stop and len(ranks):
                    # un-pipelined, the closure check lands *before* dispatch:
                    # doomed candidates never ship to the device at all
                    sub = self._apriori_kept(ranks, surv_ranks)
                    if sub is not None:
                        stages["host_pruned_subset"] += float((~sub).sum())
                        ranks, parents, qarr = ranks[sub], parents[sub], qarr[sub]
            else:
                ranks = np.empty((0, 2), np.int32)
                parents = np.empty(0, np.int64)
                qarr = np.empty(0, np.int32)

        stages["mining_waves"] = time.perf_counter() - t0
        return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)

    def extend_with_sentinel(self, prepared: PreparedDB):
        """``(planes, singleton)``: the prepared N-lists as the wave kernel
        reads them, ``(3, K_s + 1, W_s)`` int32, with one all-padding rank row
        ``(INT32_MAX, -1, 0)`` at index ``K_s`` — the slot
        ``SegmentHandle.g2l`` routes globally-known-but-locally-absent items
        to — and ``singleton = planes[2]`` (a contiguous plane). Built once
        per segment; the queries never rebuild it."""
        if prepared.packed is None:
            raise ValueError("cannot extend an F1-only PreparedDB (no N-lists packed)")
        K, W = prepared.fl.k, prepared.width
        planes = torch.empty((3, K + 1, W), dtype=torch.int32, device=prepared.packed.device)
        planes[:, :K] = prepared.packed[0].permute(2, 0, 1)
        planes[0, K] = INF32
        planes[1, K] = -1
        planes[2, K] = 0
        return planes, planes[2]

    def mine_prepared_segments(
        self,
        handles: "list[SegmentHandle]",
        items: np.ndarray,
        supports: np.ndarray,
        C: np.ndarray,
        min_count: int,
        *,
        max_k: int | None | type(Ellipsis) = ...,
        peak_base: int = 0,
        executor=None,
        weights=None,
        seed=None,
        seed_out=None,
    ) -> PrepostResult:
        """The k>2 wave loop over a *segmented* database (the streaming
        reduce step): candidates are planned once against the global
        F-lists (``items``/``supports`` in stream-rank order, ``C`` the
        summed upper-triangular F2 matrix in the same rank space), each
        wave launches the fused intersect kernel (B1) once per segment, and
        the per-candidate supports are summed across segments before
        thresholding — exact because segments partition the transactions,
        so itemset supports are additive over them.

        Every segment carries its own merged-N-list state chain between
        waves (a segment is one partition's PPC forest); the *slot* layout
        (``_pack_wave``) is global and shared, so parent reads at levels > 2
        need no per-segment translation — only base/extension item indices
        (and the level-2 singleton parents) route through each segment's
        ``g2l``. Pipelining semantics match ``mine_prepared``.

        ``executor`` abstracts *where* waves run: the default
        ``LocalSegmentExecutor(self, handles)`` executes them in-process.

        ``weights`` (or an executor carrying a ``weights`` attribute)
        switches the cross-segment reduce to the float64 weighted sum of
        time-decayed mining: ``supports``/``C``/``min_count`` are then read
        as float accumulations and emitted supports are floats; the
        per-segment device path is untouched (integer-exact), only the host
        reduce and threshold run in float.

        ``seed`` prunes with a standing query's previous waves (exact
        integer mode only): a dict of per-itemset support *upper bounds*.
        A candidate whose bound misses ``min_count`` is provably infrequent
        and is dropped before dispatch (``host_pruned_seed``) along with the
        whole subtree it would have opened; a candidate absent from the seed
        is always kept, so the answer is bit-identical to an unseeded mine.
        ``seed_out``, if a dict, collects the exact reduced support of every
        candidate this mine settles (frequent or not).
        """
        cfg = self.cfg
        max_k = cfg.max_k if max_k is ... else max_k
        items_arr = np.asarray(items, np.int32)
        if executor is None:
            executor = LocalSegmentExecutor(self, handles, weights=weights)
        elif weights is not None:
            raise ValueError(
                "pass decay weights through the executor, not alongside one"
            )
        weighted = getattr(executor, "weights", None) is not None
        supports = np.asarray(supports, np.float64 if weighted else np.int64)
        as_sup = float if weighted else int
        K = len(items_arr)
        stages = self.last_stage_times = {
            "job1_flist": 0.0, "job2_ppc_pack": 0.0, "f2_scan": 0.0,
            "mining_waves": 0.0,
            "planned_candidates": 0.0,
            "host_pruned_parent": 0.0, "host_pruned_subset": 0.0,
            "host_pruned_seed": 0.0,
        }
        itemsets: dict[tuple[int, ...], int] = {}
        freq = supports >= min_count
        # result F-list stays support-descending (ties: item asc) whatever
        # the stream-rank order is — the contract every miner reports
        f_items = items_arr[freq]
        f_sups = supports[freq]
        order = np.lexsort((f_items, -f_sups))
        flist_items = f_items[order]
        for it, s in zip(flist_items.tolist(), f_sups[order].tolist()):
            itemsets[(int(it),)] = as_sup(s)
        peak = int(peak_base)
        if K == 0 or max_k == 1 or not itemsets or executor.n_segments == 0:
            return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)

        seed_keep = None
        if seed is not None and not weighted:

            def seed_keep(ranks_):
                cand = np.sort(items_arr[ranks_], axis=1)
                return np.fromiter(
                    (seed.get(tuple(t), min_count) >= min_count
                     for t in cand.tolist()),
                    bool, len(cand),
                )

        pair_ok = (C + C.T) >= min_count
        pair_packed = np.packbits(pair_ok, axis=1)
        prefix_packed = np.packbits(np.tri(K, K, -1, dtype=bool), axis=1)
        executor.begin()
        qs, ps = np.nonzero(C >= min_count)
        ranks = np.stack([qs, ps], axis=1).astype(np.int32)
        parents = ps.astype(np.int64)
        qarr = qs.astype(np.int32)
        level = 2
        pending = None  # (ranks, slot_of, token) of the wave in flight

        t0 = time.perf_counter()
        while len(ranks) or pending is not None:
            if seed_keep is not None and len(ranks):
                km = seed_keep(ranks)
                if not km.all():
                    stages["host_pruned_seed"] += float((~km).sum())
                    ranks, parents, qarr = ranks[km], parents[km], qarr[km]
            dispatched = None
            if len(ranks) and (max_k is None or level <= max_k) and len(itemsets) < cfg.max_itemsets:
                idx, slot_of, _ = self._pack_wave(ranks, parents, qarr)
                stages["planned_candidates"] += float(len(ranks))
                with trace.span("mine.wave", k=level, candidates=len(ranks),
                                segments=executor.n_segments):
                    token = executor.dispatch(level, idx, len(ranks))
                dispatched = (ranks, parents, slot_of, token)
                peak = max(peak, int(executor.state_bytes))
                level += 1
            if not cfg.pipeline_waves and dispatched is not None:
                pending = (dispatched[0], dispatched[2], dispatched[3])
                dispatched = None

            surv_mask = None
            surv_ranks = surv_slots = None
            if pending is not None:
                p_ranks, p_slots, p_token = pending
                # the streaming reduce: per-candidate supports summed over
                # segments (additivity over disjoint partitions), THEN
                # thresholded — this blocks on the settled wave
                with trace.span("mine.reduce", k=level - 1):
                    host = executor.collect(p_token)
                peak = max(peak, int(executor.state_bytes))
                svals = host[p_slots]
                keep = svals >= min_count
                if seed_out is not None and len(p_ranks):
                    # exact settled supports of EVERY candidate (dead ones
                    # included — what the next refresh's seed prunes)
                    all_items = np.sort(items_arr[p_ranks], axis=1)
                    for t, s in zip(all_items.tolist(), svals.tolist()):
                        seed_out[tuple(t)] = as_sup(s)
                if keep.any():
                    emit_items = np.sort(items_arr[p_ranks[keep]], axis=1)
                    for t, s in zip(emit_items.tolist(), svals[keep].tolist()):
                        itemsets[tuple(t)] = as_sup(s)
                surv_mask = np.zeros(host.shape[0], bool)
                surv_mask[p_slots[keep]] = True
                surv_ranks, surv_slots = p_ranks[keep], p_slots[keep]
                pending = None

            if dispatched is not None:
                d_ranks, d_parents, d_slot_of, d_token = dispatched
                if surv_mask is not None:
                    kept = surv_mask[d_parents]
                    stages["host_pruned_parent"] += float((~kept).sum())
                    d_ranks, d_slot_of = d_ranks[kept], d_slot_of[kept]
                    if cfg.early_stop:
                        sub = self._apriori_kept(d_ranks, surv_ranks)
                        if sub is not None:
                            stages["host_pruned_subset"] += float((~sub).sum())
                            d_ranks, d_slot_of = d_ranks[sub], d_slot_of[sub]
                pending = (d_ranks, d_slot_of, d_token)
                ranks, parents, qarr = self._extensions(
                    d_ranks, d_slot_of, pair_packed, prefix_packed, K
                )
            elif surv_mask is not None and not cfg.pipeline_waves:
                ranks, parents, qarr = self._extensions(
                    surv_ranks, surv_slots, pair_packed, prefix_packed, K
                )
                if cfg.early_stop and len(ranks):
                    sub = self._apriori_kept(ranks, surv_ranks)
                    if sub is not None:
                        stages["host_pruned_subset"] += float((~sub).sum())
                        ranks, parents, qarr = ranks[sub], parents[sub], qarr[sub]
            else:
                ranks = np.empty((0, 2), np.int32)
                parents = np.empty(0, np.int64)
                qarr = np.empty(0, np.int32)

        stages["mining_waves"] = time.perf_counter() - t0
        return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)

    def mine(
        self,
        rows: np.ndarray,
        n_items: int,
        min_count: int,
        *,
        max_k: int | None | type(Ellipsis) = ...,
    ) -> PrepostResult:
        """One-shot mine = ``prepare`` at ``min_count`` + ``mine_prepared``.
        ``max_k=...`` inherits the config's cap; an explicit value overrides
        it per call."""
        max_k = self.cfg.max_k if max_k is ... else max_k
        prepared = self.prepare(
            rows, n_items, min_count, need_waves=max_k is None or max_k > 1
        )
        res = self.mine_prepared(prepared, min_count, max_k=max_k)
        # one-shot path pays its own prep: fold the real stage times back in
        self.last_stage_times.update(prepared.stage_times)
        return res
