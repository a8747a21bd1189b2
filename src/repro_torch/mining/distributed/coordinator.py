"""Coordinator: the paper's JobTracker. Plans every query once against
the global F-lists, broadcasts waves to the workers, sums their partial
supports, and owns placement + failover.

``DistributedMiner`` is a drop-in for ``StreamingMiner`` behind
``MiningEngine.distribute`` — same ``append(rows) -> dict`` /
``mine(spec) -> MineResult`` surface, so the ``MiningService`` submit
path is unchanged for callers. Internally:

  - global state (stream item ranks, summed counts, summed F2 matrix,
    row totals) lives in a ``SegmentedDB`` used *without* device
    segments — the coordinator holds plans, never N-lists;
  - each appended batch is placed on one worker (byte-balanced greedy,
    ``placement``) which builds the segment via the shared
    ``build_segment`` (snapshot-first against the shared store dir);
  - ``mine`` runs ``HPrepostMiner.mine_prepared_segments`` with a
    ``RemoteSegmentExecutor``: the identical planning loop the local
    path uses, with wave execution swapped for a broadcast + reduce
    over workers — results are bit-identical by construction;
  - failover: a dead worker's segments (the coordinator retains every
    batch's host rows, its append log) are re-placed over survivors,
    who warm-restore them from the content-addressed snapshots with
    zero prep recompute; an in-flight query is then replayed from
    level 2 — deterministic planning makes the retry bit-identical.

Devices: the coordinator plans on the host and launches no kernel. Each
worker is a spawned process bound to its own device — on a CUDA engine,
worker ``wid`` gets ``cuda:{wid % torch.cuda.device_count()}`` (so one
card may hold several workers, each with its own CUDA context), else the
engine's device. ``spawn``, never ``fork``: CUDA cannot be initialised in
a forked child, and the coordinator may already have touched the card.
Before spawning CUDA workers the coordinator builds the kernels once, so
the workers load them instead of each running ``nvcc`` in its first
``prep``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.atomic import (
    fsync_write, replace_file_atomic, save_array, write_dir_atomic,
)
from repro_torch.core import encoding as enc
from repro_torch.fault import failures
from repro_torch.mining.distributed import placement
from repro_torch.mining.distributed import protocol as pr
from repro_torch.mining.distributed.transport import Listener
from repro_torch.mining.distributed.worker import worker_main
from repro_torch.mining.engine import MiningEngine
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec
from repro_torch.mining.stream.segmented import SegmentedDB
from repro_torch.mining.stream.spec import StreamSpec

_digest = MiningEngine._digest


class WorkerDied(RuntimeError):
    """One worker stopped answering (EOF, reset, or reply timeout).

    ``timeout`` distinguishes a reply that never came (retryable: resend
    with a fresh seq; a late duplicate reply is skipped as a stale frame)
    from a connection that is provably gone (resending cannot help)."""

    def __init__(self, worker_id: int, why: str = "", *, timeout: bool = False):
        super().__init__(f"worker {worker_id} died" + (f": {why}" if why else ""))
        self.worker_id = worker_id
        self.timeout = timeout


class NoLiveWorkers(RuntimeError):
    """Every worker is gone; the database cannot answer waves."""


@dataclasses.dataclass
class WorkerHandle:
    wid: int
    chan: object
    proc: object
    alive: bool = True
    next_seq: int = 0
    device: str = "cpu"  # the torch device the worker process is bound to
    pid: int = 0  # from its hello
    hello_s: float = 0.0  # process start to hello received (spawn cost)


@dataclasses.dataclass
class SegmentMeta:
    """Coordinator-side record of one placed segment: enough to re-prep
    it anywhere (host rows + imposed item order), never device state."""

    seg_id: int
    rows: np.ndarray  # raw (unpadded) host batch — the append log entry
    n_rows_real: int
    local_items: np.ndarray
    worker: int
    seq: int = 0  # append-order position, shared with empty-batch entries
    nbytes: int = 0
    prep_bytes: int = 0
    digest: str = ""
    # the worker-reported local F2 block, kept so window expiry can
    # subtract it from the global C exactly (the retraction half of the
    # reduce) without a round-trip
    C_block: np.ndarray | None = None


class RemoteSegmentExecutor:
    """Wave execution over RPC: ``dispatch`` broadcasts one planned wave
    to every participating worker without blocking (the coordinator's
    pipelined planner keeps running), ``collect`` gathers the per-worker
    support sums and adds them — the cross-machine reduce."""

    def __init__(self, coord: "DistributedMiner", items: np.ndarray):
        self.coord = coord
        self.items = items
        owners = {m.worker for m in coord._segments.values()}
        self.workers = [w for w in coord._live() if w.wid in owners]
        self.n_segments = len(coord._segments)
        self.state_bytes = 0

    def begin(self) -> None:
        c = self.coord
        seqs = [
            (w, c._send(w, {"op": pr.OP_QUERY_BEGIN, "items": self.items}))
            for w in self.workers
        ]
        for w, seq in seqs:
            c._expect(w, seq)

    def dispatch(self, level, idx, live, local):
        # the port's executor contract: the wave's (3, Cpad) int64 index
        # rows, each candidate group's live slots and the locality flag.
        # No stop count: segmented waves never early-stop (per-worker
        # supports are partial until the cross-machine reduce), so the
        # workers run B1 only
        c = self.coord
        msg = {
            "op": pr.OP_WAVE, "level": int(level),
            "idx": np.asarray(idx, np.int64), "live": np.asarray(live, np.int64),
            "local": bool(local),
        }
        c._miner.stage_counters["waves"] += 1
        c._miner.stage_counters["seg_waves"] = (
            c._miner.stage_counters.get("seg_waves", 0) + self.n_segments
        )
        t_disp = time.perf_counter()
        return [(w, c._send(w, msg)) for w in self.workers], idx.shape[1], t_disp

    def collect(self, token) -> np.ndarray:
        pairs, cpad, t_disp = token
        total = np.zeros(cpad, np.int64)
        state_bytes = 0
        tel = self.coord.engine.telemetry
        name = self.coord.name
        for w, seq in pairs:
            rep = self.coord._expect(w, seq)
            # dispatch -> reply-consumed latency per worker: the raw
            # material for straggler detection. Collection order skews a
            # later worker's reading upward by at most the time spent
            # summing earlier replies (its reply was already buffered).
            tel.histogram(f"dist.{name}.worker{w.wid}.wave_rpc_s").record(
                time.perf_counter() - t_disp
            )
            total += np.asarray(rep["sups"], np.int64)
            state_bytes += int(rep.get("state_bytes", 0))
        self.state_bytes = state_bytes
        return total

    def finish(self) -> None:
        for w in self.workers:
            if w.alive:
                try:
                    self.coord._request(w, {"op": pr.OP_QUERY_END})
                except WorkerDied:
                    pass  # the next op will notice and fail over


class DistributedMiner:
    """One distributed, append-only mining database: N spawned worker
    processes behind a ``StreamingMiner``-shaped front."""

    def __init__(self, engine, n_items: int, *, workers: int = 2,
                 spec: MineSpec | None = None, stream_spec: StreamSpec | None = None,
                 snapshot_dir: str | None = None, heartbeat_s: float = 0.0,
                 rpc_timeout_s: float = 180.0, spawn_timeout_s: float = 120.0,
                 rpc_attempts: int = 3, rpc_backoff_s: float = 0.05,
                 restart_budget: int = 0, checkpoint_dir: str | None = None,
                 name: str = "default"):
        if workers < 1:
            raise ValueError(f"need at least 1 worker, got {workers}")
        self.engine = engine
        self.name = name
        self.n_items = int(n_items)
        self.spec = spec if spec is not None else MineSpec()
        self.stream_spec = stream_spec if stream_spec is not None else StreamSpec()
        self._fe = engine.frontend("hprepost")
        self._device_cfg = self._fe._device_config(self.spec)
        # planner only: the coordinator never runs wave kernels itself
        self._miner = self._fe.miner_for(self.spec)
        if self._miner._Mb != 1:
            # workers always run their own single-device miner; a coordinator
            # planning model-partitioned slot layouts would disagree with
            # how workers interpret the wave's local parent rows
            raise ValueError(
                "distributed mining plans in an unpartitioned candidate "
                "space; use a 1x1 coordinator mesh (model shards stay "
                "inside each worker)"
            )
        if snapshot_dir is None and engine.snapshot_store is not None:
            snapshot_dir = engine.snapshot_store.dir
        self.snapshot_dir = snapshot_dir
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.rpc_attempts = max(1, int(rpc_attempts))
        self.rpc_backoff_s = float(rpc_backoff_s)
        self.heartbeat_s = float(heartbeat_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        # workers re-spawned after death, total, before the pool is allowed
        # to shrink permanently. Default 0: a killed worker stays gone (its
        # segments live on the survivors); production serves pass a budget.
        self.restart_budget = int(restart_budget)
        self.checkpoint_dir = checkpoint_dir
        if self.stream_spec.decay < 1.0:
            raise ValueError(
                "decayed supports are a single-process stream mode; "
                "distributed databases mine the exact integer path only"
            )
        if self.stream_spec.min_sup_floor > 0:
            raise ValueError(
                "min_sup_floor is a single-process stream mode; distributed "
                "databases rank every item they see"
            )
        self.db = SegmentedDB(n_items)  # global ranks/counts/C/n_rows only
        self._segments: dict[int, SegmentMeta] = {}
        self._next_seg = 0
        self._append_seq = 0  # append-order clock over segments AND empties
        # (seq, row count) of segment-less (all-PAD) appends: their rows
        # joined db.n_rows, so sliding windows must age them out too
        self._empty_rows: list[list[int]] = []
        self._expired: set[int] = set()  # window-expired seg ids (log stays)
        self.rows_appended = 0  # monotone: never decremented by expiry
        self._op_lock = threading.RLock()
        from repro_torch.mining.continuous import StandingRegistry

        self.standing = StandingRegistry(self)
        self.stats = {
            "appends": 0, "queries": 0, "empty_batches": 0,
            "workers_spawned": int(workers), "workers_lost": 0,
            "failovers": 0, "query_retries": 0,
            "reassigned_segments": 0, "reassign_snapshot_restores": 0,
            "reassign_rebuilds": 0,
            "rpc_timeouts": 0, "rpc_retries": 0,
            "respawns": 0, "respawn_failures": 0,
            "restored_appends": 0, "checkpoint_failures": 0,
            # sliding-window churn + standing-query delivery telemetry
            "expires": 0, "expired_segments": 0, "expired_rows": 0,
            "expire_errors": 0,
            "standing_queries": 0, "diffs_delivered": 0, "diff_errors": 0,
            "diff_latency_s_total": 0.0, "last_diff_latency_s": 0.0,
            "seed_pruned_candidates": 0,
        }
        self._listener = Listener()
        self._workers: dict[int, WorkerHandle] = {}
        self._stop = threading.Event()
        self._monitor = None
        self._spawn_workers(workers, spawn_timeout_s)
        if self.heartbeat_s > 0:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name=f"dist-hb-{name}", daemon=True
            )
            self._monitor.start()
        if self.checkpoint_dir is not None:
            try:
                self._restore_checkpoint()
            except BaseException:
                self.close()  # a refused checkpoint leaves no worker behind
                raise

    # ------------------------------------------------------------ lifecycle
    def _worker_device(self, wid: int) -> str:
        """The device worker ``wid`` binds: a card of its own where the
        engine's device is CUDA (round robin over the cards), else the
        engine's device."""
        dev = self.engine.device
        if dev.type == "cuda":
            return f"cuda:{wid % torch.cuda.device_count()}"
        return str(dev)

    def _spawn_procs(self, wids: list[int]):
        """Start worker processes for ``wids`` (spawn, not fork: each
        worker initializes its own torch runtime and CUDA context).
        -> {wid: (process, device, start time)}."""
        devices = {wid: self._worker_device(wid) for wid in wids}
        if any(d.startswith("cuda") for d in devices.values()):
            from repro_torch.kernels import _cuda

            _cuda.build_all()  # once here, not in every worker's first prep
        ctx = mp.get_context("spawn")
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        path = os.environ.get("PYTHONPATH", "")
        if src_root not in path.split(os.pathsep):
            os.environ["PYTHONPATH"] = (
                src_root + (os.pathsep + path if path else "")
            )
        procs = {}
        for wid in wids:
            p = ctx.Process(
                target=worker_main,
                args=(self._listener.address, wid, devices[wid], self.n_items,
                      self.spec, self.stream_spec.row_pad, self.snapshot_dir),
                daemon=True, name=f"mine-worker-{wid}",
            )
            p.start()
            procs[wid] = (p, devices[wid], time.perf_counter())
        return procs

    def _accept_hellos(self, procs: dict, spawn_timeout_s: float) -> None:
        """Take one hello per started process. A process that exits before
        its hello (a worker asked for a device it cannot bind) fails the
        spawn at once instead of at the deadline; on any failure every
        process of ``procs`` without a handle is killed."""
        deadline = time.monotonic() + spawn_timeout_s
        pending = set(procs)
        try:
            while pending:
                try:
                    chan = self._listener.accept(
                        min(max(deadline - time.monotonic(), 0.1), 0.5))
                except TimeoutError:
                    dead = [w for w in sorted(pending) if not procs[w][0].is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"worker {dead[0]} exited with code "
                            f"{procs[dead[0]][0].exitcode} before its hello"
                        ) from None
                    if time.monotonic() >= deadline:
                        raise
                    continue
                hello = chan.recv(max(deadline - time.monotonic(), 0.1))
                if hello.get("op") != pr.OP_HELLO:
                    raise pr.ProtocolError(f"expected hello, got {hello!r}")
                wid = int(hello["worker_id"])
                proc, device, t_start = procs[wid]
                self._workers[wid] = WorkerHandle(
                    wid=wid, chan=chan, proc=proc, device=device,
                    pid=int(hello.get("pid", 0)),
                    hello_s=time.perf_counter() - t_start,
                )
                pending.discard(wid)
        except BaseException:
            for wid in pending:
                procs[wid][0].kill()
                procs[wid][0].join(timeout=5)
            raise

    def _spawn_workers(self, n: int, spawn_timeout_s: float) -> None:
        try:
            self._accept_hellos(self._spawn_procs(list(range(n))), spawn_timeout_s)
        except BaseException:
            self.close()  # no process of a failed start outlives it
            raise

    def close(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        for w in self._workers.values():
            if w.alive:
                try:
                    self._request(w, {"op": pr.OP_SHUTDOWN}, timeout=5)
                except Exception:
                    pass
            w.chan.close()
        for w in self._workers.values():
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5)
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- rpc
    def _live(self) -> list[WorkerHandle]:
        return [w for w in self._workers.values() if w.alive]

    def _loads(self) -> dict[int, int]:
        loads = {w.wid: 0 for w in self._live()}
        for m in self._segments.values():
            if m.worker in loads:
                loads[m.worker] += m.nbytes
        return loads

    def _send(self, w: WorkerHandle, body: dict) -> int:
        if not w.alive:
            raise WorkerDied(w.wid, "already marked dead")
        msg = dict(body)
        msg["seq"] = w.next_seq
        w.next_seq += 1
        try:
            w.chan.send(msg)
        except (pr.ConnectionClosed, OSError) as e:
            raise WorkerDied(w.wid, str(e)) from e
        return msg["seq"]

    def _expect(self, w: WorkerHandle, seq: int, timeout: float | None = None):
        """The reply for ``seq``, skipping stale frames: after an aborted
        (failed-over) query — or a timed-out-and-retried request — a
        worker may still flush replies for seqs this coordinator stopped
        caring about."""
        timeout = self.rpc_timeout_s if timeout is None else timeout
        while True:
            try:
                rep = w.chan.recv(timeout)
            except TimeoutError as e:
                raise WorkerDied(w.wid, str(e), timeout=True) from e
            except (pr.ConnectionClosed, pr.ProtocolError) as e:
                raise WorkerDied(w.wid, str(e)) from e
            got = rep.get("seq", -1)
            if got < seq:
                continue  # stale reply from an aborted pipeline
            if got > seq:
                raise pr.ProtocolError(
                    f"worker {w.wid}: reply seq {got} overtook expected {seq}"
                )
            if not rep.get("ok", False):
                raise RuntimeError(f"worker {w.wid} op failed: {rep.get('error')}")
            return rep

    def _request(self, w: WorkerHandle, body: dict, timeout: float | None = None):
        """One request/reply exchange, with bounded exponential-backoff
        retries on reply *timeouts* (``rpc_attempts`` sends total).

        Only request/reply ops route through here — ping, stats, prep,
        inject, drop, query_end, shutdown — and all of them are idempotent
        on the worker (a re-prep rebuilds the same content-addressed
        segment). A retry resends under a fresh seq, so a late duplicate
        reply for the timed-out send is discarded by ``_expect``'s
        stale-frame skip. Pipelined wave traffic deliberately does NOT
        retry: ``dispatch`` advances per-segment merged state on the
        worker, so the only sound recovery for a lost wave is failover +
        full deterministic query replay (see ``mine``). A dead connection
        (reset/EOF) is also never retried — resending cannot help."""
        attempt = 0
        while True:
            try:
                return self._expect(w, self._send(w, body), timeout)
            except WorkerDied as e:
                if not e.timeout:
                    raise
                self.stats["rpc_timeouts"] += 1
                attempt += 1
                if attempt >= self.rpc_attempts:
                    raise
                self.stats["rpc_retries"] += 1
                time.sleep(min(self.rpc_backoff_s * (2 ** (attempt - 1)), 2.0))

    # ------------------------------------------------------------ failover
    def _mark_dead(self, wid: int) -> None:
        w = self._workers[wid]
        if not w.alive:
            return
        w.alive = False
        w.chan.close()
        self.stats["workers_lost"] += 1

    def _failover(self, wid: int) -> None:
        """Topology change: retire ``wid``, re-place its segments over the
        survivors (best-fit decreasing), each restored snapshot-first —
        same build_segment, same key, so zero recompute when the store
        holds it. Survivor deaths during the re-place loop fold in.

        With a ``restart_budget``, a replacement worker is then spawned
        and the displaced segments migrate back onto it (the failover in
        reverse, also snapshot-first) — the pool only shrinks once the
        budget is spent."""
        self._mark_dead(wid)
        self.stats["failovers"] += 1
        displaced: list[int] = []
        while True:
            orphans = [
                m for m in self._segments.values()
                if not self._workers[m.worker].alive
            ]
            if not orphans:
                break
            loads = self._loads()
            if not loads:
                if self._respawn() is None:
                    raise NoLiveWorkers(
                        f"all {self.stats['workers_spawned']} workers are gone"
                    )
                continue  # the fresh worker re-preps the orphans directly
            plan = placement.replan([(m.seg_id, m.nbytes) for m in orphans], loads)
            try:
                for seg_id in sorted(plan):
                    m = self._segments[seg_id]
                    rep = self._prep_on(self._workers[plan[seg_id]], m)
                    m.worker = plan[seg_id]
                    displaced.append(seg_id)
                    self.stats["reassigned_segments"] += 1
                    if rep["source"] == "snapshot":
                        self.stats["reassign_snapshot_restores"] += 1
                    else:
                        self.stats["reassign_rebuilds"] += 1
                break
            except WorkerDied as e:
                self._mark_dead(e.worker_id)
                continue
        new_wid = self._respawn()
        if new_wid is not None:
            self._rebalance_to(new_wid, displaced)
        self._checkpoint_manifest()  # placement map changed

    # ------------------------------------------------------------- respawn
    def _respawn(self) -> int | None:
        """Spawn one replacement worker (fresh wid — seq state and process
        handles never alias a dead worker's). None when the budget is
        spent or the spawn itself failed."""
        if self.restart_budget <= 0:
            return None
        self.restart_budget -= 1
        wid = max(self._workers) + 1
        try:
            self._accept_hellos(self._spawn_procs([wid]), self.spawn_timeout_s)
        except Exception:
            self.stats["respawn_failures"] += 1
            return None
        self.stats["respawns"] += 1
        self.stats["workers_spawned"] += 1
        return wid

    def _rebalance_to(self, wid: int, seg_ids: list[int]) -> None:
        """Migrate ``seg_ids`` onto worker ``wid``: re-prep there
        (snapshot-first — the store still holds every segment the dead
        worker built, so this is a restore, not a rebuild), then drop the
        temporary copy from the survivor that carried it. Any failure
        leaves the segment where it was — correctness never depends on
        the migration, only balance does. A death mid-migration (of the
        new worker or of a survivor we ask to drop) routes back through
        ``_failover``, which re-places every dead owner's segments — a
        segment is never left on a worker nobody serves from."""
        w = self._workers[wid]
        for seg_id in seg_ids:
            m = self._segments.get(seg_id)
            if m is None:
                continue
            old = m.worker
            try:
                rep = self._prep_on(w, m)
            except WorkerDied:
                self.stats["respawn_failures"] += 1
                # the fresh worker may already own earlier migrations:
                # full repair, not just a mark (recursion is bounded by
                # the restart budget + live worker count)
                self._failover(wid)
                return
            m.worker = wid
            if rep["source"] == "snapshot":
                self.stats["reassign_snapshot_restores"] += 1
            else:
                self.stats["reassign_rebuilds"] += 1
            old_w = self._workers.get(old)
            if old_w is not None and old_w.alive:
                try:
                    self._request(old_w, {"op": "drop", "seg_ids": [seg_id]})
                except WorkerDied as e:
                    self._failover(e.worker_id)

    def _prep_on(self, w: WorkerHandle, m: SegmentMeta):
        return self._request(w, {
            "op": pr.OP_PREP, "seg_id": m.seg_id, "rows": m.rows,
            "local_items": m.local_items, "n_rows_real": m.n_rows_real,
        })

    def kill_worker(self, wid: int) -> None:
        """Hard-kill one worker process (chaos / smoke hook). The death is
        *not* marked here — detection is the coordinator's job, via the
        next RPC failure or a missed heartbeat."""
        self._workers[wid].proc.kill()
        self._workers[wid].proc.join(timeout=10)

    def inject_fault(self, wid: int, fault_op: str, *, after: int = 0,
                     when: str = "before") -> None:
        """Arm a deterministic in-worker death (repro.fault posture): the
        worker exits on its ``after``-th next request matching
        ``fault_op`` — ``when='before'`` drops the request mid-op (no
        reply), ``when='after_reply'`` dies between ops."""
        with self._op_lock:
            self._request(self._workers[wid], {
                "op": pr.OP_INJECT, "fault_op": fault_op,
                "after": after, "when": when,
            })

    def worker_stats(self) -> dict[int, dict]:
        """Per-live-worker telemetry (prep/snapshot/wave counters)."""
        with self._op_lock:
            out = {}
            for w in self._live():
                out[w.wid] = self._request(w, {"op": pr.OP_STATS})
            return out

    # -------------------------------------------------------------- append
    def append(self, rows_batch) -> dict:
        """Ingest one batch: register it in the global rank space, place
        it on the least-loaded worker, fold the returned F2 block into
        the global C — the map step runs remotely, the Job 1/F2 reduce
        here."""
        rows = np.array(rows_batch, np.int32, copy=True)
        if rows.ndim != 2:
            raise ValueError(f"rows batch must be 2-D (R, L), got shape {rows.shape}")
        if rows.size and int(rows.max()) >= self.n_items:
            raise ValueError(
                f"batch contains item id {int(rows.max())} >= n_items={self.n_items}"
            )
        t0 = time.perf_counter()
        with self._op_lock:
            hist = enc.item_support(rows, self.n_items)
            new_items = self.db.register_batch(hist)
            self.db.n_rows += len(rows)
            self.stats["appends"] += 1
            self.rows_appended += len(rows)
            source = "empty"
            worker = -1
            seq = self._append_seq
            self._append_seq += 1
            if hist.sum() > 0:
                local_items = self.db.present_in_order(hist)
                seg_id = self._next_seg
                self._next_seg += 1
                m = SegmentMeta(
                    seg_id=seg_id, rows=rows, n_rows_real=len(rows),
                    local_items=local_items, worker=-1, seq=seq,
                )
                wid, rep = self._place_segment(m)
                gr = self.db.rank_of[local_items]
                m.C_block = np.asarray(rep["C"], np.int64)
                self.db.C[np.ix_(gr, gr)] += m.C_block
                m.worker = wid
                m.nbytes = int(rep["nbytes"])
                m.prep_bytes = int(rep["prep_bytes"])
                m.digest = self._padded_digest(rows)
                self._segments[seg_id] = m
                source = rep["source"]
                worker = wid
                self._checkpoint_append(m)
            else:
                self.stats["empty_batches"] += 1
                self._empty_rows.append([seq, len(rows)])
                self._checkpoint_manifest()
            n_exp_seg, n_exp_rows = self._expire()
            diffs = self.standing.refresh_all(
                "expire" if n_exp_rows else "append"
            )
            append_s = time.perf_counter() - t0
            self.engine.telemetry.histogram(
                f"dist.{self.name}.append_s").record(append_s)
            return {
                "rows": int(len(rows)),
                "total_rows": int(self.db.n_rows),
                "segments": len(self._segments),
                "new_items": int(len(new_items)),
                "expired": int(n_exp_seg),
                "expired_rows": int(n_exp_rows),
                "diffs": int(diffs),
                "prep_source": source,
                "worker": worker,
                "append_s": append_s,
            }

    def _expire(self) -> "tuple[int, int]":
        """Sliding-window expiry (lock held): a placement-aware drop over
        the append-order ledger of segments AND segment-less (all-PAD)
        appends. Victims are the oldest entries beyond the minimal suffix
        covering the window; each segment drop subtracts its histogram and
        recorded F2 block from the global reduce (exact retraction), frees
        the device copy on its owning worker (best-effort — a dead owner
        folds into failover), and is recorded in the checkpoint manifest so
        a restore replays expired batches rank-only; an empty-entry drop
        just releases its rows from ``db.n_rows``. An injected
        ``stream.expire`` failure skips the pass; the window self-heals on
        the next append. Returns (segments expired, rows expired)."""
        ss = self.stream_spec
        if not ss.windowed:
            return 0, 0
        by_batches = bool(ss.window_batches)
        # distributed databases never compact: one segment == one batch
        entries = [
            (m.seq, 1 if by_batches else m.n_rows_real, m)
            for m in self._segments.values()
        ] + [
            (q, 1 if by_batches else n, None)
            for q, n in self._empty_rows if n
        ]
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
        seg_victims = [e[2] for e in victims if e[2] is not None]
        by_worker: dict[int, list[int]] = {}
        for m in seg_victims:
            del self._segments[m.seg_id]
            self._expired.add(m.seg_id)
            gr = self.db.rank_of[m.local_items]
            self.db.C[np.ix_(gr, gr)] -= m.C_block
            self.db.counts -= enc.item_support(m.rows, self.n_items)
            self.db.n_rows -= m.n_rows_real
            by_worker.setdefault(m.worker, []).append(m.seg_id)
        empty_seqs = {e[0] for e in victims if e[2] is None}
        empty_rows = sum(n for q, n in self._empty_rows if q in empty_seqs)
        if empty_seqs:
            self._empty_rows = [
                e for e in self._empty_rows if e[0] not in empty_seqs
            ]
            self.db.n_rows -= empty_rows
        for wid, seg_ids in by_worker.items():
            w = self._workers.get(wid)
            if w is None or not w.alive:
                continue  # its device copies died with it; the log is here
            try:
                self._request(w, {"op": "drop", "seg_ids": seg_ids})
            except WorkerDied as e:
                try:
                    self._failover(e.worker_id)
                except NoLiveWorkers:
                    pass  # surfaced by the next append/mine
        n_rows = sum(m.n_rows_real for m in seg_victims) + empty_rows
        self.stats["expires"] += 1
        self.stats["expired_segments"] += len(seg_victims)
        self.stats["expired_rows"] += n_rows
        self._checkpoint_manifest()
        return len(seg_victims), n_rows

    # ----------------------------------------------------- standing queries
    def register(self, spec: MineSpec):
        """Register a standing query against the distributed database:
        mined now and re-answered (with a ``MineDiff``) after every
        append/expiry — same semantics as ``StreamingMiner.register``."""
        with self._op_lock:
            return self.standing.register(spec)

    def cancel(self, query) -> None:
        with self._op_lock:
            self.standing.cancel(query)

    def _place_segment(self, m: SegmentMeta, prefer: int | None = None):
        """Place (prep) one segment on a live worker: ``(wid, reply)``.
        ``prefer`` pins the first attempt (checkpoint replay honors the
        recorded placement when that worker still exists); deaths fold
        into failover and the placement is retried on the survivors."""
        while True:
            loads = self._loads()
            if not loads:
                raise NoLiveWorkers("no live workers to place the batch on")
            wid = prefer if prefer in loads else placement.choose_worker(loads)
            try:
                return wid, self._prep_on(self._workers[wid], m)
            except WorkerDied as e:
                prefer = None
                self._failover(e.worker_id)

    # ----------------------------------------------------------- checkpoint
    # The coordinator's durable state is tiny and host-only: the append
    # log (each batch's raw rows) plus a manifest (append order, empty-
    # batch row counts, placement map). Everything else — ranks, counts,
    # C, segment N-lists — is deterministically derivable by replaying
    # appends, with the workers' content-addressed snapshot store making
    # the replay a warm restore instead of a recompute. Entry dirs are
    # written with ``write_dir_atomic`` and the manifest with
    # ``replace_file_atomic``, so a crash mid-checkpoint can only lose
    # the latest append, never corrupt the log.
    CK_SCHEMA = 1

    def _ck_entry(self, seg_id: int) -> str:
        return os.path.join(self.checkpoint_dir, f"seg-{int(seg_id):06d}")

    def _checkpoint_append(self, m: SegmentMeta) -> None:
        """Persist one appended batch + the updated manifest. Best-effort:
        a full/readonly disk degrades durability, never the append."""
        if self.checkpoint_dir is None:
            return
        try:
            os.makedirs(self.checkpoint_dir, exist_ok=True)

            def writer(tmp):
                save_array(os.path.join(tmp, "rows.npy"), np.asarray(m.rows, np.int32))
                fsync_write(os.path.join(tmp, "meta.json"), json.dumps({
                    "seg_id": int(m.seg_id), "n_rows_real": int(m.n_rows_real),
                }).encode())

            write_dir_atomic(self._ck_entry(m.seg_id), writer)
        except Exception:
            self.stats["checkpoint_failures"] += 1
            return
        self._checkpoint_manifest()

    def _checkpoint_manifest(self) -> None:
        if self.checkpoint_dir is None:
            return
        try:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            manifest = {
                "schema": self.CK_SCHEMA,
                "n_items": int(self.n_items),
                "segments": [int(s) for s in sorted(self._segments)],
                "expired": [int(s) for s in sorted(self._expired)],
                "placement": {
                    str(s): int(self._segments[s].worker)
                    for s in sorted(self._segments)
                },
                "seg_seq": {
                    str(s): int(self._segments[s].seq)
                    for s in sorted(self._segments)
                },
                "empty_rows": [
                    [int(q), int(n)] for q, n in self._empty_rows
                ],
            }
            replace_file_atomic(
                os.path.join(self.checkpoint_dir, "manifest.json"),
                json.dumps(manifest, sort_keys=True).encode(),
            )
        except Exception:
            self.stats["checkpoint_failures"] += 1

    def _restore_checkpoint(self) -> None:
        """Replay the append log into this (fresh) coordinator: same batch
        order -> same rank space, counts, C, and seg_ids — an identical
        ``SegmentedDB``. Placement honors the recorded map where those
        worker ids exist, and segment preps restore snapshot-first, so a
        restart of a large database is I/O, not recompute."""
        path = os.path.join(self.checkpoint_dir, "manifest.json")
        try:
            with open(path) as f:
                manifest = json.load(f)
        except OSError:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            return  # nothing recorded yet: a fresh database
        if manifest.get("schema") != self.CK_SCHEMA:
            raise ValueError(
                f"checkpoint schema {manifest.get('schema')!r} unsupported"
            )
        if int(manifest.get("n_items", -1)) != self.n_items:
            raise ValueError(
                f"checkpoint was written for n_items={manifest.get('n_items')}, "
                f"this coordinator has n_items={self.n_items}"
            )
        placed = {int(k): int(v) for k, v in manifest.get("placement", {}).items()}
        seqs = {int(k): int(v) for k, v in manifest.get("seg_seq", {}).items()}
        expired = {int(s) for s in manifest.get("expired", [])}
        live = {int(s) for s in manifest.get("segments", [])}
        with self._op_lock:
            for seg_id in sorted(live | expired):
                rows = np.load(os.path.join(self._ck_entry(seg_id), "rows.npy"))
                if seg_id in expired:
                    self._replay_expired(seg_id, rows)
                else:
                    self._replay_append(
                        seg_id, rows, prefer=placed.get(seg_id),
                        seq=seqs.get(seg_id),
                    )
                self.stats["restored_appends"] += 1
            for entry in manifest.get("empty_rows", []):
                q, n = int(entry[0]), int(entry[1])
                self.db.n_rows += n
                self._empty_rows.append([q, n])
                self._append_seq = max(self._append_seq, q + 1)
                self.stats["appends"] += 1
                self.stats["empty_batches"] += 1
                self.stats["restored_appends"] += 1

    def _replay_append(self, seg_id: int, rows: np.ndarray,
                       prefer: int | None, seq: int | None = None) -> None:
        """One checkpointed append, re-registered and re-placed — the body
        of ``append`` minus validation (the original append did it) and
        minus re-checkpointing what is already on disk."""
        hist = enc.item_support(rows, self.n_items)
        self.db.register_batch(hist)
        self.db.n_rows += len(rows)
        self.stats["appends"] += 1
        self.rows_appended += len(rows)
        local_items = self.db.present_in_order(hist)
        self._next_seg = max(self._next_seg, seg_id + 1)
        if seq is None:
            seq = self._append_seq
        self._append_seq = max(self._append_seq, seq + 1)
        m = SegmentMeta(
            seg_id=seg_id, rows=rows, n_rows_real=len(rows),
            local_items=local_items, worker=-1, seq=seq,
        )
        wid, rep = self._place_segment(m, prefer=prefer)
        gr = self.db.rank_of[local_items]
        m.C_block = np.asarray(rep["C"], np.int64)
        self.db.C[np.ix_(gr, gr)] += m.C_block
        m.worker = wid
        m.nbytes = int(rep["nbytes"])
        m.prep_bytes = int(rep["prep_bytes"])
        m.digest = self._padded_digest(rows)
        self._segments[seg_id] = m

    def _replay_expired(self, seg_id: int, rows: np.ndarray) -> None:
        """One checkpointed append that later expired: replayed rank-only.
        The original append registered the batch's items (extending the
        append-only rank space) and its later expiry subtracted the
        histogram back out — so the replay registers then subtracts,
        reconstructing identical ranks with net-zero counts, and never
        places anything on a worker."""
        hist = enc.item_support(rows, self.n_items)
        self.db.register_batch(hist)
        self.db.counts -= hist
        self.stats["appends"] += 1
        self.rows_appended += len(rows)
        self._next_seg = max(self._next_seg, seg_id + 1)
        self._expired.add(seg_id)

    def _padded_digest(self, rows: np.ndarray) -> str:
        pad = self.stream_spec.row_pad
        rp = -(-len(rows) // pad) * pad
        if rp != len(rows):
            padded = np.full((rp, rows.shape[1]), enc.PAD, np.int32)
            padded[: len(rows)] = rows
            rows = padded
        return _digest(rows)[2]

    # --------------------------------------------------------------- query
    def mine(self, spec: MineSpec, _seed: dict | None = None,
             _seed_out: dict | None = None) -> MineResult:
        """One exact query: plan centrally, execute waves on the workers,
        sum supports, threshold. A worker death mid-query triggers
        failover and a full replay — planning is deterministic, so the
        replayed query answers bit-identically."""
        if spec.algorithm != "hprepost":
            raise ValueError(
                f"distributed queries run on the hprepost backend, got {spec.algorithm!r}"
            )
        # only prep-level knobs are pinned by the packed segments;
        # execution-only knobs (blocks, backend, early_stop, tune) are free
        # to differ per query and are honored via the query's own miner
        if self._fe._prep_config(spec) != self._device_cfg.prep_key():
            raise ValueError(
                "query device config differs from the database's; segments were "
                "packed under the creation spec — open a new database to change knobs"
            )
        self._fe._check_patterns(spec)
        t0 = time.perf_counter()
        with self._op_lock:
            while True:
                try:
                    out = self._mine_once(spec, t0, _seed, _seed_out)
                except WorkerDied as e:
                    self._failover(e.worker_id)
                    self.stats["query_retries"] += 1
                    continue
                self.engine.telemetry.histogram(
                    f"dist.{self.name}.query_s").record(time.perf_counter() - t0)
                return out

    def _mine_once(self, spec: MineSpec, t0: float,
                   seed: dict | None = None,
                   seed_out: dict | None = None) -> MineResult:
        items = np.asarray(self.db.order, np.int32)
        sups = self.db.counts[items] if len(items) else np.zeros(0, np.int64)
        C = self.db.C.copy()
        n_rows = self.db.n_rows
        min_count = spec.resolve(max(n_rows, 1))
        if len(items) > spec.max_f1:
            raise ValueError(
                f"|stream F-list|={len(items)} exceeds max_f1={spec.max_f1}"
            )
        executor = RemoteSegmentExecutor(self, items)
        qminer = self._fe.miner_for(spec)  # honors execution-only knobs
        res = qminer.mine_prepared_segments(
            None, items, sups, C, min_count, max_k=spec.max_k,
            peak_base=sum(m.prep_bytes for m in self._segments.values()),
            executor=executor, seed=seed, seed_out=seed_out,
        )
        executor.finish()
        self.stats["queries"] += 1
        out = self._fe._finish(
            res.itemsets, res.total_count, res.n_explicit, res.peak_bytes,
            dict(qminer.last_stage_times), res.flist_items,
            spec=spec, min_count=min_count, n_rows=n_rows, t0=t0, prep_shared=True,
        )
        out.service_stats.update(
            prep_source="distributed",
            stream_segments=len(self._segments),
            stream_digest=self._db_digest(),
            workers=len(self._live()),
        )
        return out

    def _db_digest(self) -> str:
        h = hashlib.sha1()
        for sid in sorted(self._segments):
            h.update(self._segments[sid].digest.encode())
        h.update(str(self.db.n_rows).encode())
        return h.hexdigest()

    # ------------------------------------------------------------ heartbeat
    def _monitor_loop(self) -> None:
        """Ping live workers every ``heartbeat_s``; a missed beat retires
        the worker and re-places its segments. Skips a cycle whenever an
        operation holds the lock — a busy worker is not a dead worker."""
        while not self._stop.wait(self.heartbeat_s):
            if not self._op_lock.acquire(blocking=False):
                continue
            try:
                for w in list(self._live()):
                    try:
                        self._request(
                            w, {"op": pr.OP_PING},
                            timeout=max(self.heartbeat_s * 4, 2.0),
                        )
                    except WorkerDied as e:
                        try:
                            self._failover(e.worker_id)
                        except NoLiveWorkers:
                            pass  # surfaced by the next append/mine
            finally:
                self._op_lock.release()

    def flush(self) -> None:  # StreamingMiner surface parity (no-op here)
        return None
