"""HPrepost on a mesh of torch devices: the paper's MapReduce miner.

The Hadoop pipeline maps onto a ``(data, model)`` mesh of D data shards by M
candidate groups (``repro_torch.launch.mesh``; the default is the 1×1 mesh
on one device), driven by one host loop as the reference's is:

  Job 1 (word count)      -> histogram kernel per data shard, summed
  Job 2 map (F-list sort) -> ``rank_encode_torch`` per shard
  Job 2 reduce (PPC-tree) -> sort-based ``build_ppc_torch`` per shard: each
                             data shard owns the PPC-tree and N-lists of its
                             block of rows, one Hadoop reducer's state, packed
                             into its ``(K, W, 3)`` buffer
  F2 scan                 -> co-occurrence kernel per shard, summed
  k>2 mining waves        -> batched N-list intersections: candidates split
                             into M groups, one fused intersect + support
                             launch per (shard, group) position reading each
                             candidate's parent state and N-lists by index,
                             per-candidate supports summed over the shards
                             (supports are additive over row blocks)

Shard d's prep runs on position (d, 0); the other positions of row d read
its planes through a ``.to()`` that copies only onto another device. The
reference's ``psum`` over ``data`` is a sum of the shards' partial tensors
on the miner's reduce device (position (0, 0)). Between waves, parent
states either stay on their position (locality dispatch: a candidate is
placed in its parent's group) or are gathered from every group of the row
(the shuffle).

The streaming reduce (``mine_prepared_segments``) runs the same wave loop
over a segmented database: one B1 launch per segment per position per
wave, against each segment's per-shard ``(3, K_s + 1, W_s)`` planes
(``extend_with_sentinel``), and the per-segment supports summed on the host.

Mining state per candidate: the merged N-list counts aligned with the
candidate's base-item code slots — ``(Cs, W)`` buffers per position,
candidate counts bucketed to powers of two like the reference. The host
drives the level loop (as the Hadoop job tracker does) with the reference's
NumPy planning, and keeps one wave in flight: wave l+1 is dispatched before
wave l's supports are read back (through a pinned buffer and an event, so
the read waits for wave l alone).
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
from repro_torch.device import StagingRing, wait_ready
from repro_torch.fault import failures
from repro_torch.kernels.cooccur.ops import cooccurrence_matrix
from repro_torch.kernels.histogram.ops import item_histogram
from repro_torch.kernels.nlist_intersect.ops import EXACT_MAX, nlist_wave
from repro_torch.launch import cost
from repro_torch.launch.mesh import Mesh, make_mesh
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
    partition_candidates: bool = True  # mode B (PFP groups over `model`)
    locality_dispatch: bool = True  # children placed in their parent's group:
    # the inter-wave shuffle becomes a position-local read, at the cost of
    # per-group padding under skew
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
    # per data shard d, its (K, W, 3) int32 N-lists on the miner's position
    # (d, 0); None when F1-only
    packed: Any
    C: np.ndarray  # (K, K) upper-triangular F2 co-occurrence counts
    prep_bytes: int  # per-shard footprint: rows + F-list + packed
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
        reference's layout: ``packed`` is gathered to ``(D, K, W, 3)``, each
        leading slice one reducer's PPC-tree state, so the payload restores
        onto any mesh with the same data-shard count."""
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
            out["packed"] = np.stack([p.cpu().numpy() for p in self.packed])
        return out

    @classmethod
    def from_host(cls, payload: dict, miner: "HPrepostMiner") -> "PreparedDB":
        """Load a ``to_host`` payload onto ``miner``'s mesh: shard d's
        N-lists onto position (d, 0).

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
                    f"mesh has D={miner.D}; per-shard PPC state does not re-shard "
                    f"— re-prepare on this mesh"
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
                packed = tuple(torch.from_numpy(np.array(ph[d])).to(miner._grid[d, 0])
                               for d in range(n_shards))
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
        """Per-shard prep footprint attributable to one threshold: rows +
        F-list + the N-list prefix of ranks frequent at ``min_count`` (the
        floor F-list is support-descending, so that prefix is exactly what
        an independent mine at this threshold would pack), as the reference
        counts it."""
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

    ``planes[d]`` are data shard d's N-lists as the wave kernel reads them,
    ``(3, K_s + 1, W_s)`` int32 (pre, post, count) on the miner's position
    (d, 0), with one all-padding *sentinel* rank row at index ``K_s``
    (``extend_with_sentinel``); ``planes[d][2]`` are the level-2 singleton
    states. ``g2l`` maps every global stream rank to the segment's local
    rank, with ranks absent from the segment mapped to the sentinel. The
    wave kernel cuts every list at its padding, so the sentinel row is an
    empty N-list: a candidate touching an item the segment never saw
    reports support 0 there — precisely its contribution to the global
    (additive) support.
    (The reference's handle holds the same rows as a ``(D, K_s + 1, W_s,
    3)`` buffer.)

    ``g2l=None`` is the identity: a prepared database's own ``(3, K, W)``
    planes in its own rank space, with no sentinel row (``mine_prepared``).

    ``ready``: ``(device, event)`` pairs recorded after the planes were
    built, when they were built on other streams than the queries' (a
    compaction's); None otherwise."""

    planes: tuple  # per data shard: (3, K_s + 1, W_s) device N-lists incl. the sentinel row
    g2l: np.ndarray | None  # (K_global,) int32: stream rank -> local rank | K_s; None: identity
    ready: Any = None


class LocalSegmentExecutor:
    """Runs planned waves in this process — the execution half of the one
    wave loop (``HPrepostMiner._run_waves``), split from the planning so
    that each caller hands the planner its own executor. Three implement
    the contract: this class over one prepared database's planes
    (``mine_prepared``) or over segment handles (``mine_prepared_segments``),
    and the coordinator's ``RemoteSegmentExecutor`` over worker processes,
    each of which runs this class over its own segments.

    Contract (the reference's, with the port's wave layout):

      - ``n_segments``: how many transaction partitions answer waves; 0
        short-circuits the wave loop (F1-only result).
      - ``begin()``: reset per-query state to the level-2 singleton
        bootstrap.
      - ``dispatch(level, idx, live, local)``: launch one planned wave over
        every segment and mesh position; ``idx`` is the wave's host ``(3,
        Cpad)`` int64 (parent, base, extension) rows from
        ``HPrepostMiner._pack_wave`` in the global rank space, candidate
        group g in columns ``[g·Cs, (g+1)·Cs)``, ``live`` each group's live
        slots (a prefix of the group) and ``local`` whether parents are
        read in their own group (locality dispatch) or gathered from every
        group (the shuffle). Fires ``failures`` site ``mine.wave`` and
        counts the wave in ``stage_counters``. Returns an opaque token and
        does not block on device results (pipelining). B2 (early stop at
        ``stop_count`` > 0) runs only where the kernel sees final supports,
        one prepared database on one data shard; segment waves run B1, as
        their supports are partial until the cross-segment reduce.
      - ``collect(token)``: block, and return the per-candidate supports
        summed over this executor's segments as a host vector — the
        paper's reduce step. With ``weights`` the reduce is instead the
        float64 weighted sum ``Σ w_s · sup_s`` (time-decayed supports: the
        per-segment integer supports stay exact on the device; damping
        happens only in this host reduce).
      - ``weights``: optional per-segment float weights, or None for the
        exact integer reduce — the planner reads this attribute to decide
        integer vs float threshold semantics.
      - ``state_bytes``: footprint of the in-flight merged-N-list states
        after the latest dispatch/collect (peak accounting, per position).
    """

    def __init__(self, miner: "HPrepostMiner", handles: "list[SegmentHandle]",
                 weights=None, stop_count: int = 0):
        self.miner = miner
        self.handles = list(handles)
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            if len(weights) != len(self.handles):
                raise ValueError(
                    f"{len(weights)} segment weights for {len(self.handles)} handles"
                )
        self.weights = weights
        self.stop_count = stop_count
        self._planes: list | None = None
        self._prev: list | None = None
        self.state_bytes = 0

    @property
    def n_segments(self) -> int:
        return len(self.handles)

    def begin(self) -> None:
        for h in self.handles:
            if h.ready is not None:
                # planes built on other streams (a compaction's): order this
                # query's streams after the build, and mark the planes in use
                # here so the allocator cannot hand their blocks out while
                # these waves still read them, whenever the segment is dropped
                wait_ready(h.ready)
                for p in h.planes:
                    p.record_stream(torch.cuda.current_stream(p.device))
        self._planes = [self.miner._position_planes(h.planes) for h in self.handles]
        self._prev = [[[p[2] for p in row] for row in planes] for planes in self._planes]
        self.state_bytes = 0

    def dispatch(self, level: int, idx: np.ndarray, live: np.ndarray, local: bool):
        m = self.miner
        failures.fire("mine.wave")
        new_states, parts = [], []
        for h, planes, prev in zip(self.handles, self._planes, self._prev):
            ix = idx
            if h.g2l is not None:
                # level-2 parents are singleton ranks (per-segment rows); later
                # levels read the parent state by global slot, shared by layout
                ix = np.stack([h.g2l[idx[0]] if level == 2 else idx[0],
                               h.g2l[idx[1]], h.g2l[idx[2]]]).astype(np.int64)
            new_s, sups = m._mesh_wave(planes, prev, ix, live, level, local, self.stop_count)
            new_states.append(new_s)
            parts.extend(sups)
        m.stage_counters["waves"] += 1
        if self.handles[0].g2l is not None:
            m.stage_counters["seg_waves"] = m.stage_counters.get("seg_waves", 0) + self.n_segments
        self._prev = new_states
        self.state_bytes = sum(int(s[0][0].numel() * 4) for s in new_states)
        # one read of every segment's supports: (S, Cpad) on the host
        return _HostRead(parts, (len(self.handles), idx.shape[1]))

    def collect(self, token) -> np.ndarray:
        stacked = token.get()
        if self.weights is not None:
            return np.tensordot(self.weights, stacked.astype(np.float64), axes=1)
        if len(stacked) == 1:
            return stacked[0]  # one handle's supports are the sum: no copy
        return np.sum(stacked, axis=0, dtype=np.int64)


# a mine's ``last_stage_times``: prep and wave seconds, and the planning counters
# (candidates shipped, and killed on the host by a dead parent or a subset)
_STAGES = ("job1_flist", "job2_ppc_pack", "f2_scan", "mining_waves",
           "planned_candidates", "host_pruned_parent", "host_pruned_subset")


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
    """Device vectors copied back without blocking the caller, concatenated
    in order and reshaped to ``shape``: on CUDA non-blocking copies into
    one pinned buffer plus an event per device, so ``get`` waits for the
    work before the copies only — never for waves dispatched after them."""

    def __init__(self, parts, shape):
        self._shape = shape
        self._events = []
        if parts[0].is_cuda:
            self._host = torch.empty(sum(p.numel() for p in parts), dtype=parts[0].dtype,
                                     pin_memory=True)
            at = 0
            for p in parts:
                self._host[at:at + p.numel()].copy_(p, non_blocking=True)
                at += p.numel()
            for dev in dict.fromkeys(p.device for p in parts):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._events.append(ev)
        else:
            self._host = parts[0] if len(parts) == 1 else torch.cat(parts)

    def get(self) -> np.ndarray:
        for ev in self._events:
            ev.synchronize()
        return self._host.numpy().reshape(self._shape)


def _sum_to(parts, device: torch.device, first_local: bool = True) -> torch.Tensor:
    """Σ ``parts`` on ``device``: the reference's ``psum`` over the data
    shards. Integer counts stay exact: each is bounded by the row count,
    which ``prepare`` guards below the kernels' int32 bound. Charged as an
    all-reduce of one part's bytes, every part leaving its position but the
    first when ``first_local`` (it lies on the reduce position)."""
    if len(parts) > 1:
        nb = parts[0].numel() * parts[0].element_size()
        cost.collective("all-reduce", nb, nb * (len(parts) - first_local))
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, read-only arrays included: the
    engine's fingerprint memo freezes the arrays it has hashed, and nothing
    here writes through the tensor."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)


def _staged(device: torch.device) -> bool:
    """Whether rows reach ``device`` through a staging ring: CUDA only. On
    the CPU a staged copy would only add a copy."""
    return device.type == "cuda"


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _rows(keep, *arrays):
    """The rows ``keep`` selects of each of the wave planner's row-aligned
    arrays (ranks, slots or parents, q, allowed sets)."""
    return tuple(a[keep] for a in arrays)


class HPrepostMiner:
    """The N-list miner on a mesh of torch devices: D data shards by M
    candidate groups. ``mesh=None`` is the 1×1 mesh on ``device`` (CUDA by
    default, raising when none is present; ``device="cpu"`` runs the plain
    PyTorch versions). ``data_axis`` may name several mesh axes (e.g.
    ``("pod", "data")``), whose sizes multiply into D; ``model_axis`` splits
    the candidates (mode B), and ``model_axis=None`` or
    ``partition_candidates=False`` keeps them in one group (mode A)."""

    def __init__(self, device=None, config: HPrepostConfig = HPrepostConfig(), *,
                 mesh: Mesh | None = None, data_axis: str | tuple[str, ...] = "data",
                 model_axis: str | None = "model"):
        if mesh is None:
            mesh = make_mesh((1, 1), ("data", "model"), devices=[device])
        elif device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.mesh = mesh
        self.data_axis = (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)
        self.model_axis = model_axis
        self.cfg = config
        # (D, M) devices: position (d, m) holds data shard d, candidate group m
        self._grid = mesh.grid(self.data_axis, model_axis)
        self.D, self.M = self._grid.shape
        # the reduce device: shard sums and host reads land here
        self.device = self._grid[0, 0]
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
        # the rows' pinned slots, made at the first prepare on a CUDA position
        self._staging = StagingRing()

    @property
    def _Mb(self) -> int:
        """Candidate groups a wave is split into: M in mode B, else 1."""
        return self.M if (self.cfg.partition_candidates and self.model_axis) else 1

    @property
    def devices(self) -> list[torch.device]:
        """The distinct devices this miner's positions lie on."""
        return list(dict.fromkeys(self._grid.flat))

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

        The rows are padded with ``PAD`` rows to ``Rp = ceil(R0/D)·D`` and
        split into D contiguous blocks; each data shard's stages run on its
        position (d, 0), and the histograms and F2 matrices are summed.

        ``need_waves=False`` stops after the F-list (for ``max_k == 1``
        traffic, where the tree/N-lists are never consulted).

        ``flist`` imposes an external item order instead of deriving it
        support-descending from this database — the streaming path's global
        stream order, which every segment must share so cross-segment
        N-list ancestor relations agree. Job 1 is skipped then (the caller
        already counted the batch, and no histogram kernel is launched),
        and the result is marked ``support_ordered=False``: it can only be
        mined through ``mine_prepared_segments``."""
        with trace.span("prep"):
            cfg = self.cfg
            D = self.D
            stages: dict[str, float] = {}
            t0 = time.perf_counter()
            R0, L = rows.shape
            Rs = -(-R0 // D)  # rows per shard
            # the kernels accumulate counts in int32; every count they can
            # produce is bounded by the shard's row count, so refuse what could wrap
            if self.backend == "cuda" and Rs >= EXACT_MAX:
                raise ValueError(
                    f"per-shard row count {Rs} reaches the int32 exact-integer bound "
                    f"2^31-1 of the CUDA kernels' counts; shard the database over "
                    f"more devices (D={D})"
                )
            # each stage's span is timed on position (0, 0)'s stream while
            # profiling; the times are read after F2's .cpu() has waited for it
            with trace.span("prep.h2d", device=self.device):
                shard_rows = self._shard_rows(rows)

            with trace.span("prep.job1", device=self.device):
                if flist is None:
                    supports = self._job1(shard_rows, n_items).cpu().numpy()
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

            rows_flist_bytes = Rs * L * 4 + int(fl.items.nbytes + fl.supports.nbytes)
            prep_bytes = rows_flist_bytes
            stages["job2_ppc_pack"] = 0.0
            stages["f2_scan"] = 0.0
            packed = None
            C = np.zeros((K, K), np.int64)
            W = 0
            if K > 0 and need_waves:
                t0 = time.perf_counter()
                with trace.span("prep.job2", device=self.device):
                    ranked, trees = self._job2(shard_rows, torch.from_numpy(fl.rank_lut()), K,
                                               n_items)
                    self.stage_counters["job2"] += 1
                with trace.span("prep.pack", device=self.device):
                    # W covers the longest N-list of any shard (the reference's pmax)
                    longest = [torch.bincount(item, minlength=K).max() for item, *_ in trees]
                    w_needed = max(int(torch.stack([n.to(self.device) for n in longest]).max()), 1)
                    W = cfg.nlist_width or _pow2(max(w_needed, 8))
                    packed = tuple(pack_nlists_torch(*tree, K, W)[0] for tree in trees)
                    self.stage_counters["pack"] += 1
                stages["job2_ppc_pack"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                with trace.span("prep.f2", device=self.device):
                    if K > 1:
                        C = self._jobf2(ranked, K).cpu().numpy()
                        self.stage_counters["f2"] += 1
                    C = np.triu(C, 1)
                stages["f2_scan"] = time.perf_counter() - t0
                prep_bytes += K * W * 3 * 4
            trace.settle_device_times()

            return PreparedDB(
                fl=fl, n_items=n_items, n_rows=R0, min_count_floor=int(min_count_floor),
                width=W, packed=packed, C=C,
                prep_bytes=prep_bytes, rows_flist_bytes=rows_flist_bytes,
                stage_times=stages, f1_only=not need_waves, n_shards=D,
                support_ordered=flist is None,
            )

    # -------------------------------------------------- the prep stages
    # (``prepare`` runs them; ``launch.dryrun_fim`` times and costs each)
    def _shard_rows(self, rows: np.ndarray) -> list[torch.Tensor]:
        """Per data shard d, its block of ``ceil(R/D)`` rows (the tail
        padded with PAD rows) on position (d, 0). A CUDA position's block
        arrives through the miner's staging ring, its PAD rows filled on
        the device; a CPU position reads a whole block in place."""
        R0, L = rows.shape
        Rs = -(-R0 // self.D)
        rows_c = np.require(rows, np.int32, ["C"])
        out = []
        for d in range(self.D):
            dev = self._grid[d, 0]
            block = rows_c[d * Rs:(d + 1) * Rs]
            staged = _staged(dev)
            if not staged and len(block) == Rs:
                out.append(_host_tensor(block))
                continue
            dst = torch.empty((Rs, L), dtype=torch.int32, device=dev)
            if staged:
                trace.count("prep.h2d_chunks", self._staging.copy(block, dst[:len(block)]))
            else:
                dst[:len(block)].copy_(_host_tensor(block))
            dst[len(block):].fill_(enc.PAD)
            out.append(dst)
        return out

    def _job1(self, shard_rows, n_items: int) -> torch.Tensor:
        """Job 1: each shard's item histogram (B3) on its position, summed
        on the reduce device."""
        hists = [item_histogram(r, n_bins=n_items, backend=self.cfg.backend) for r in shard_rows]
        return _sum_to(hists, self.device)

    def _job2(self, shard_rows, lut: torch.Tensor, K: int, n_items: int):
        """Job 2: each shard's rows rank-encoded through ``lut`` and its
        PPC-tree built, on its position. -> (ranked rows, trees) a shard."""
        ranked, trees = [], []
        for r in shard_rows:
            ranked.append(enc.rank_encode_torch(r, lut.to(r.device), n_items))
            w = torch.ones(r.shape[0], dtype=torch.int64, device=r.device)
            trees.append(build_ppc_torch(ranked[-1], w, K))
        return ranked, trees

    def _jobf2(self, ranked, K: int) -> torch.Tensor:
        """F2: each shard's (K, K) co-occurrence matrix (B4) on its
        position, summed on the reduce device."""
        coocs = [cooccurrence_matrix(r, n_items=K, backend=self.cfg.backend) for r in ranked]
        return _sum_to(coocs, self.device)

    # ---------------------------------------------------------------- waves
    def _pack_wave(self, ranks, parents, qarr, level: int = 2, slots_per_shard: int = 0):
        """Host slot assignment for one wave: candidate i -> device slot
        ``slot_of[i]``, the reference's layout. At level 2, or without
        locality dispatch, candidates fill the slots in order, padded to
        ``Mb`` groups of a power-of-two multiple of ``candidate_unit``; with
        it, each candidate lands in its parent's group (the previous wave's
        ``slots_per_shard`` slots each) and reads its parent by local row.
        Either way a group's live slots are a prefix of its ``Cs`` slots; the
        rest are padding, which the wave kernel reads nothing for and writes
        zeros to.

        -> (idx (3, Cpad) int64 rows (parent, base, extension), group g in
        columns [g·Cs, (g+1)·Cs); slot_of; Cpad)."""
        unit = self.cfg.candidate_unit
        Mb = self._Mb
        Cn = len(ranks)
        if level == 2 or not self.cfg.locality_dispatch:
            Cs = unit * _pow2((Cn + unit * Mb - 1) // (unit * Mb))
            slot_of = np.arange(Cn, dtype=np.int64)
            parent_rows = parents
        else:
            # bucket children onto their parent's group; the stable argsort
            # over bucket ids yields each candidate's rank within its bucket
            # without any per-candidate loop
            bucket = np.minimum(parents.astype(np.int64) // slots_per_shard, Mb - 1)
            counts = np.bincount(bucket, minlength=Mb)
            Cs = unit * _pow2((int(counts.max()) + unit - 1) // unit)
            order = np.argsort(bucket, kind="stable")
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            pos = np.empty(Cn, np.int64)
            pos[order] = np.arange(Cn) - starts[bucket[order]]
            slot_of = bucket * Cs + pos
            parent_rows = parents % slots_per_shard  # local row
        Cpad = Cs * Mb
        idx = np.zeros((3, Cpad), np.int64)
        idx[0, slot_of] = parent_rows
        idx[1, slot_of] = ranks[:, 1]
        idx[2, slot_of] = qarr
        return idx, slot_of, Cpad

    def _group_live(self, slot_of: np.ndarray, Cpad: int) -> np.ndarray:
        """Live slots of each candidate group (a prefix of the group)."""
        return np.bincount(slot_of // (Cpad // self._Mb), minlength=self._Mb)

    def _position_planes(self, shard_planes) -> list[list[torch.Tensor]]:
        """``[d][g]``: shard d's planes on position (d, g)'s device (a copy
        only where that is another device than the shard's)."""
        for d in range(self.D):
            nb = shard_planes[d].numel() * shard_planes[d].element_size()
            cost.collective("collective-permute", nb * (self._Mb - 1), nb * (self._Mb - 1))
        return [[shard_planes[d].to(self._grid[d, g]) for g in range(self._Mb)]
                for d in range(self.D)]

    def _wave(self, planes, prev_state, idx, n_live: int, stop_count: int, plan=None):
        """One launch at one position: the fused intersect + support kernel
        reads each live candidate's parent state and N-lists in place by
        ``idx`` — no gathered copies. B2 (early stop at ``stop_count``) where
        the plan says early stop and the threshold is positive, else B1."""
        if plan is None:
            plan = self._kernel_plan(idx.shape[1], planes.shape[2])
        if not isinstance(idx, torch.Tensor):
            idx = _to_device(idx, planes.device)
        # the launch's bytes whatever the data: every slot's state row and
        # support written, the live index columns read (``ops.wave_cost``'s
        # floor), for the wave kernels' roofline share
        trace.count("wave.floor_bytes",
                    idx.shape[1] * planes.shape[2] * 4 + idx.shape[1] * 4 + 3 * n_live * 8)
        return nlist_wave(
            planes, prev_state, idx, n_live, backend=plan.backend, la_block=plan.la_block,
            early_stop=plan.early_stop and stop_count > 0, min_count=stop_count,
        )

    def _mesh_wave(self, planes, prev, idx, live, level: int, local: bool, stop_count: int):
        """One wave on every (d, g) position: group g's columns of ``idx``
        against shard d's ``planes[d][g]``, parents from ``prev[d][g]`` (at
        level 2 the shard's singleton counts; with ``local`` the position's
        own previous block) or, for the shuffle, from row d's previous blocks
        of every group gathered onto the position. -> (new states ``[d][g]``
        ``(Cs, W)``, per group the supports summed over the shards on the
        reduce device)."""
        D, Mb = self.D, self._Mb
        Cs = idx.shape[1] // Mb
        plan = self._kernel_plan(idx.shape[1], planes[0][0].shape[2])
        groups = np.ascontiguousarray(idx.reshape(3, Mb, Cs).transpose(1, 0, 2))
        on_dev, gathered = {}, {}
        new = [[None] * Mb for _ in range(D)]
        parts = [[] for _ in range(Mb)]
        for d in range(D):
            for g in range(Mb):
                dev = self._grid[d, g]
                if (g, dev) not in on_dev:
                    on_dev[g, dev] = _to_device(groups[g], dev)
                if level == 2 or local:
                    state = prev[d][g]
                else:
                    if (d, dev) not in gathered:
                        away = sum(prev[d][j].numel() * 4 for j in range(Mb) if j != g)
                        cost.collective("all-gather", away, away)  # the shuffle's parent rows
                        blocks = [prev[d][j].to(dev) for j in range(Mb)]
                        gathered[d, dev] = blocks[0] if Mb == 1 else torch.cat(blocks)
                    state = gathered[d, dev]
                new[d][g], sup = self._wave(planes[d][g], state, on_dev[g, dev], int(live[g]),
                                            stop_count, plan)
                parts[g].append(sup)
        return new, [_sum_to(p, self.device, first_local=g == 0) for g, p in enumerate(parts)]

    @staticmethod
    def _seed_sets(ranks, pair_packed, lower):
        """Allowed-extension sets built from the pair table: for each rank
        row, the ranks ``q2 < ranks[0]`` whose pairs with every member are
        frequent — ``lower[ranks[:, 0]]`` ANDed with the other members'
        ``pair_packed`` rows. Only the level-2 rows are seeded so; every
        later row carries its set from its parent (``_extensions``).

        -> ``(C, Kb)`` uint8, 8 ranks a byte as ``np.packbits`` packs them."""
        trace.count("plan.extend_seeded", len(ranks))
        return lower[ranks[:, 0]] & np.bitwise_and.reduce(pair_packed[ranks[:, 1:]], axis=1)

    @classmethod
    def _level2(cls, C, min_count):
        """The planning table and the level-2 candidates of a threshold.

        ``lower[r]`` is the bit-packed set ``{q2 < r : pair_ok[r, q2]}``;
        the candidates are the pairs ``(q, p)``, ``q < p``, with
        ``C[q, p] >= min_count`` in row-major order, each with its seeded
        allowed set. -> (lower, ranks, parents, q, allowed)."""
        K = C.shape[0]
        pair_packed = np.packbits((C + C.T) >= min_count, axis=1)
        lower = pair_packed & np.packbits(np.tri(K, K, -1, dtype=bool), axis=1)
        qs, ps = np.nonzero(C >= min_count)
        ranks = np.stack([qs, ps], axis=1).astype(np.int32)  # (C, 2) ascending
        # level-2 parents: singleton rank slots
        return (lower, ranks, ps.astype(np.int64), qs.astype(np.int32),
                cls._seed_sets(ranks, pair_packed, lower))

    @staticmethod
    def _extensions(ranks, slots, allowed, lower, k_items):
        """Candidate generation: extend each rank row with every rank in its
        allowed set ``allowed[row]`` — the ranks ``q2 < ranks[0]`` whose
        pairs with all members are frequent.

        Vectorized over the whole wave: the set bits are listed by one flat
        scan, row-major, and each child carries its own set,
        ``allowed[row] & lower[q2]``: the parent's set already holds the AND
        of every member's pair row below the old smallest rank, and ``q2``
        is below it, so only the new member's row and prefix are ANDed in.

        -> (ranks', parents', q', allowed') with ranks' of width
        ``ranks.shape[1]+1``."""
        k = ranks.shape[1]
        trace.count("plan.extend_rows", len(ranks))
        if not len(ranks):
            return (np.empty((0, k + 1), np.int32), np.empty(0, np.int64),
                    np.empty(0, np.int32), np.empty((0, lower.shape[1]), np.uint8))
        # a bool scan (numpy's fast path, unlike uint8) and ``np.take``
        # (several times faster than fancy indexing on these small rows)
        flat = np.flatnonzero(np.unpackbits(allowed, axis=1, count=k_items).view(bool))
        cs, q2s = np.divmod(flat, k_items)
        new_ranks = np.empty((len(cs), k + 1), np.int32)
        new_ranks[:, 0] = q2s
        new_ranks[:, 1:] = np.take(ranks, cs, axis=0)
        child = np.take(allowed, cs, axis=0)
        child &= np.take(lower, q2s, axis=0)
        return new_ranks, np.take(slots, cs), q2s.astype(np.int32), child

    @staticmethod
    def _apriori_kept(d_ranks: np.ndarray, surv_ranks: np.ndarray, k_items: int):
        """Anti-monotone host bound, boolean form: a width-``l+1`` candidate
        can reach ``min_count`` only if *every* drop-one subset of width
        ``l`` survived the settled wave — the enumeration guarantees every
        frequent width-``l`` itemset is in ``surv_ranks``, so a missing
        subset proves the candidate doomed. Position 0 (the extension item)
        is the parent the caller already checked; pair subsets are implied
        by ``pair_ok`` — so this only bites from width 4 up, and returns
        None below that.

        Membership is by exact integer keys: a width-``w`` row of ranks in
        ``[0, k_items)`` packs into ``bits = (k_items - 1).bit_length()``
        bits a rank, ``63 // bits`` whole ranks to an int64 word — one word
        where ``w·bits <= 63``, else several. Each drop-one subset's words
        are built from prefix and suffix keys of the candidate rows and looked
        up by ``searchsorted`` in the survivors' keys, sorted once a call;
        several words chain through dense ids of the survivors' leading
        words, so every lookup is on one int64."""
        l1 = d_ranks.shape[1]
        if l1 < 4 or not len(d_ranks) or not len(surv_ranks):
            return None
        w = l1 - 1
        bits = max(1, (int(k_items) - 1).bit_length())
        per = 63 // bits  # whole ranks per word
        words = [(a, min(a + per, w)) for a in range(0, w, per)]  # subset columns
        d = d_ranks.astype(np.int64)

        def key(rows, lo, hi):
            k = np.zeros(len(rows), np.int64)
            for c in range(lo, hi):
                k = (k << bits) | rows[:, c]
            return k

        # survivors numbered word by word: after word j a row's id is where
        # its words [0, j] first sit in the sorted (id, word) pairs (each
        # below n_surv², well inside int64); a query row is a survivor if
        # each of its words and pairs is found
        if len(words) > 1:
            trace.count("plan.subset_multiword", 1)
        surv = surv_ranks.astype(np.int64)
        word_tab, pair_tab, ids = [], [], None
        for a, b in words:
            sk = key(surv, a, b)
            word_tab.append(np.sort(sk))
            if ids is not None:
                sk = ids * len(word_tab[-1]) + np.searchsorted(word_tab[-1], sk)
                pair_tab.append(np.sort(sk))
            if len(word_tab) < len(words):  # the next word pairs with these ids
                ids = np.searchsorted((pair_tab or word_tab)[-1], sk)

        def find(table, q):
            i = np.minimum(np.searchsorted(table, q), len(table) - 1)
            return i, table[i] == q

        def member(q):
            ids, hit = find(word_tab[0], q[0])
            for u, p, x in zip(word_tab[1:], pair_tab, q[1:]):
                k, in_u = find(u, x)
                ids, in_p = find(p, ids * len(u) + k)
                hit &= in_u & in_p
            return hit

        def drop_one_keys():
            # dropping original column ``pos``: a word wholly before it reads
            # columns [a, b), one wholly after it [a + 1, b + 1), and the word
            # holding subset column ``pos`` joins the prefix [a, pos) to the
            # suffix [pos + 1, b + 1)
            before = [key(d, a, b) for a, b in words]
            after = [key(d, a + 1, b + 1) for a, b in words]
            for j, (a, b) in enumerate(words):
                suffix = [np.zeros(len(d), np.int64)]  # [i]: columns [b + 1 - i, b + 1)
                for c in range(b, a, -1):
                    suffix.append(suffix[-1] | (d[:, c] << (bits * (b - c))))
                prefix = np.zeros(len(d), np.int64)
                for pos in range(max(a, 1), b + 1 if b == w else b):
                    if pos > a:
                        prefix = (prefix << bits) | d[:, pos - 1]
                    mid = (prefix << (bits * (b - pos))) | suffix[b - pos]
                    yield before[:j] + [mid] + after[j + 1:]

        kept = np.ones(len(d), bool)
        tested = 0
        for q in drop_one_keys():
            kept &= member(q)
            tested += len(d)
            if not kept.any():
                break
        trace.count("plan.subset_rows", tested)
        return kept

    def _run_waves(self, executor, items_arr: np.ndarray, C: np.ndarray, min_count,
                   itemsets: dict, peak: int, max_k, *, as_sup=int, seed=None,
                   seed_out=None, segmented: bool = False) -> int:
        """The k>2 wave loop, the only one: plans each wave on the host, runs
        it through ``executor`` (``LocalSegmentExecutor``'s contract, begun)
        and adds each settled frequent itemset of ``items_arr``' ids, its
        support cast by ``as_sup``, to ``itemsets``; ``C`` is the
        upper-triangular F2 matrix in that rank space. -> ``peak`` raised
        to the executor's state bytes.

        With ``cfg.pipeline_waves`` the loop dispatches wave ``l+1`` before
        blocking on wave ``l``'s supports, so host candidate generation
        overlaps device execution. The one wave of speculation is sound:
        children of candidates that turn out infrequent report supports
        below ``min_count`` themselves (anti-monotonicity), so they can
        never be emitted; once the parent wave's supports arrive, the dead
        branches are pruned from further host enumeration.

        ``seed``, a dict of per-itemset support *upper bounds*, drops each
        candidate whose bound misses ``min_count`` (provably infrequent)
        before dispatch, with its subtree (``host_pruned_seed``); one absent
        from it is kept. ``seed_out``, if a dict, collects the reduced
        support of every candidate settled, frequent or not. ``segmented``
        tags each ``mine.wave`` span with the executor's segment count."""
        cfg = self.cfg
        stages = self.last_stage_times
        K = len(items_arr)
        wave_args = {"segments": executor.n_segments} if segmented else {}
        # level-2 candidates, each with the bit-packed set of ranks it may be
        # extended by, which its children inherit (``_extensions``)
        lower, ranks, parents, qarr, allowed = self._level2(C, min_count)
        level = 2
        slots_per_shard = 0  # of the *previous* wave (for locality bucketing)
        pending = None  # (ranks, slot_of, token, allowed) of the wave in flight

        # the span holds exactly the region the stage times
        with trace.span("mine.waves"):
            t0 = time.perf_counter()
            while len(ranks) or pending is not None:
                if seed is not None and len(ranks):
                    with trace.span("mine.plan"):
                        cand = np.sort(items_arr[ranks], axis=1)
                        km = np.fromiter((seed.get(tuple(t), min_count) >= min_count
                                          for t in cand.tolist()), bool, len(cand))
                        if not km.all():
                            stages["host_pruned_seed"] += float((~km).sum())
                            ranks, parents, qarr, allowed = _rows(km, ranks, parents, qarr,
                                                                  allowed)
                dispatched = None
                if (len(ranks) and (max_k is None or level <= max_k)
                        and len(itemsets) < cfg.max_itemsets):
                    with trace.span("mine.plan"):
                        idx, slot_of, Cpad = self._pack_wave(ranks, parents, qarr, level,
                                                             slots_per_shard)
                    stages["planned_candidates"] += float(len(ranks))
                    with trace.span("mine.wave", k=level, candidates=len(ranks), **wave_args):
                        token = executor.dispatch(level, idx, self._group_live(slot_of, Cpad),
                                                  level > 2 and cfg.locality_dispatch)
                    dispatched = (ranks, parents, slot_of, token, allowed)
                    # per position, as the reference counts it
                    peak = max(peak, int(executor.state_bytes))
                    slots_per_shard = Cpad // self._Mb
                    level += 1
                if not cfg.pipeline_waves and dispatched is not None:
                    # degrade: block right away (no speculative wave in flight,
                    # so the parent column is never consulted)
                    pending = (dispatched[0], dispatched[2], dispatched[3], dispatched[4])
                    dispatched = None

                surv_mask = None  # boolean over the settled wave's device slots
                surv_ranks = surv_slots = surv_allowed = None
                if pending is not None:
                    p_ranks, p_slots, p_token, p_allowed = pending
                    # the reduce: supports summed over segments (additive over
                    # disjoint partitions), THEN thresholded; blocks on wave l-1
                    with trace.span("mine.reduce", k=level - 1):
                        host = executor.collect(p_token)
                    peak = max(peak, int(executor.state_bytes))
                    with trace.span("mine.emit"):
                        svals = host[p_slots]
                        keep = svals >= min_count
                        if seed_out is not None and len(p_ranks):
                            # settled supports of EVERY candidate (dead ones
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
                        surv_allowed = p_allowed[keep]
                    pending = None

                with trace.span("mine.plan"):
                    if dispatched is not None:
                        d_ranks, d_parents, d_slot_of, d_token, d_allowed = dispatched
                        if surv_mask is not None:
                            # speculative wave l was enumerated before wave l-1's
                            # supports arrived; drop children of dead parents from
                            # further enumeration (their own supports self-filter)
                            kept = surv_mask[d_parents]
                            stages["host_pruned_parent"] += float((~kept).sum())
                            d_ranks, d_slot_of, d_allowed = _rows(kept, d_ranks, d_slot_of,
                                                                  d_allowed)
                            if cfg.early_stop:
                                sub = self._apriori_kept(d_ranks, surv_ranks, K)
                                if sub is not None:
                                    stages["host_pruned_subset"] += float((~sub).sum())
                                    d_ranks, d_slot_of, d_allowed = _rows(
                                        sub, d_ranks, d_slot_of, d_allowed)
                        pending = (d_ranks, d_slot_of, d_token, d_allowed)
                        ranks, parents, qarr, allowed = self._extensions(
                            d_ranks, d_slot_of, d_allowed, lower, K)
                    elif surv_mask is not None and not cfg.pipeline_waves:
                        ranks, parents, qarr, allowed = self._extensions(
                            surv_ranks, surv_slots, surv_allowed, lower, K)
                        if cfg.early_stop and len(ranks):
                            # un-pipelined, the closure check lands *before* dispatch:
                            # doomed candidates never ship to the device at all
                            sub = self._apriori_kept(ranks, surv_ranks, K)
                            if sub is not None:
                                stages["host_pruned_subset"] += float((~sub).sum())
                                ranks, parents, qarr, allowed = _rows(sub, ranks, parents,
                                                                      qarr, allowed)
                    else:
                        ranks, parents, qarr, allowed = _rows(slice(0), ranks, parents, qarr,
                                                              allowed)

            stages["mining_waves"] = time.perf_counter() - t0
        return peak

    def mine_prepared(
        self,
        prepared: PreparedDB,
        min_count: int,
        *,
        max_k: int | None | type(Ellipsis) = ...,
    ) -> PrepostResult:
        """Mine a shared ``PreparedDB``: its F1, then the wave loop
        (``_run_waves``) over a ``LocalSegmentExecutor`` of one identity
        handle on its planes. Any ``min_count >=
        prepared.min_count_floor`` is served exactly: floor structures are
        supersets, N-list supports are exact DB supports. On one data shard
        with ``cfg.early_stop`` every wave runs the early-stop kernel (B2)
        at ``min_count``: its supports are final there."""
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
        self.last_stage_times = dict.fromkeys(_STAGES, 0.0)
        k_act = prepared.k_active(min_count)
        items_arr = np.asarray(fl.items)
        itemsets = {(int(it),): int(s) for it, s in zip(
            items_arr[:k_act].tolist(), np.asarray(fl.supports)[:k_act].tolist())}
        flist_items = fl.items[:k_act]
        peak = prepared.bytes_at(min_count, self.D)
        if max_k == 1 or not itemsets:
            return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)
        if prepared.f1_only:
            raise ValueError(
                "PreparedDB was built with need_waves=False (F1 only); "
                "re-prepare with need_waves=True to mine k >= 2"
            )
        # planar (3, K, W) copy of each shard's N-lists, made on its position
        # (d, 0): the wave kernel reads each candidate's (pre, post, count)
        # rows as contiguous W-wide rows
        with trace.span("mine.planes"):
            planes = tuple(p.permute(2, 0, 1).contiguous() for p in prepared.packed)
            executor = LocalSegmentExecutor(
                self, [SegmentHandle(planes, None)],
                stop_count=min_count if (cfg.early_stop and self.D == 1) else 0)
            executor.begin()
        peak = self._run_waves(executor, items_arr, prepared.C, min_count, itemsets, peak, max_k)
        return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)

    def extend_with_sentinel(self, prepared: PreparedDB, shard: int = 0):
        """``(planes, singleton)`` of data shard ``shard``: its N-lists as the
        wave kernel reads them, ``(3, K_s + 1, W_s)`` int32 on the shard's
        device, with one all-padding rank row ``(INT32_MAX, -1, 0)`` at index
        ``K_s`` — the slot ``SegmentHandle.g2l`` routes globally-known-but-
        locally-absent items to — and ``singleton = planes[2]`` (a contiguous
        plane). Built once per segment; the queries never rebuild it."""
        if prepared.packed is None:
            raise ValueError("cannot extend an F1-only PreparedDB (no N-lists packed)")
        K, W = prepared.fl.k, prepared.width
        packed = prepared.packed[shard]
        planes = torch.empty((3, K + 1, W), dtype=torch.int32, device=packed.device)
        planes[:, :K] = packed.permute(2, 0, 1)
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
        """Mine a *segmented* database (the streaming reduce step): its F1
        from ``items``/``supports`` (the global F-lists in stream-rank
        order), then the wave loop (``_run_waves``) planned once against
        ``C`` (the summed upper-triangular F2 matrix in the same rank
        space), each wave launching the fused intersect kernel (B1) once
        per segment per mesh position, and the per-candidate supports
        summed across segments before thresholding — exact because
        segments partition the transactions, so itemset supports are
        additive over them.

        Every segment carries its own merged-N-list state chain between
        waves (a segment is one partition's PPC forest); the *slot* layout
        (``_pack_wave``) is global and shared, so parent reads at levels > 2
        need no per-segment translation — only base/extension item indices
        (and the level-2 singleton parents) route through each segment's
        ``g2l``.

        ``executor`` abstracts *where* waves run: the default
        ``LocalSegmentExecutor(self, handles)`` executes them in-process.

        ``weights`` (or an executor carrying them) makes the reduce the
        float64 weighted sum of time-decayed mining (``collect``):
        ``supports``/``C``/``min_count`` are then float accumulations and
        emitted supports floats; the device path stays integer-exact.

        ``seed``/``seed_out`` are a standing query's prune by its previous
        waves' support bounds and the settled supports for the next one
        (``_run_waves``; exact integer mode only): the answer is
        bit-identical to an unseeded mine."""
        max_k = self.cfg.max_k if max_k is ... else max_k
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
        self.last_stage_times = dict.fromkeys(_STAGES + ("host_pruned_seed",), 0.0)
        freq = supports >= min_count
        # result F-list stays support-descending (ties: item asc) whatever
        # the stream-rank order is — the contract every miner reports
        f_items = items_arr[freq]
        f_sups = supports[freq]
        order = np.lexsort((f_items, -f_sups))
        flist_items = f_items[order]
        itemsets = {(int(it),): as_sup(s)
                    for it, s in zip(flist_items.tolist(), f_sups[order].tolist())}
        peak = int(peak_base)
        if max_k == 1 or not itemsets or executor.n_segments == 0:
            return PrepostResult(itemsets, flist_items, len(itemsets), len(itemsets), peak)
        executor.begin()
        peak = self._run_waves(executor, items_arr, C, min_count, itemsets, peak, max_k,
                               as_sup=as_sup, seed=None if weighted else seed,
                               seed_out=seed_out, segmented=True)
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
