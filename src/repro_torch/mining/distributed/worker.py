"""Worker process: the paper's TaskTracker. Owns a disjoint set of
prepared segments, answers the coordinator's RPCs over one channel.

A worker is deliberately the *streaming map step* extracted into its own
process: ``prep`` is exactly ``repro_torch.mining.stream.build_segment``
(Job 2, pack and F2 under the imposed F-list: one B4 launch on CUDA, no
B3; the same snapshot keys, so a segment built by one worker warm-restores
on any other — the content-addressed ``SnapshotStore`` directory is the
shared filesystem the paper assumes of HDFS), and ``wave`` runs the fused
intersect kernel (B1) over the worker's segments via the same
``LocalSegmentExecutor`` the single-process miner uses, replying with the
per-candidate support sums over *its* partitions — its partial reduce.

Each worker is bound to one torch device, given by the coordinator: on
CUDA it makes that card current and holds its own CUDA context, and it
never falls back to the CPU (``resolve_device`` raises first). Replies
carry host NumPy only: the supports ``collect`` returns are a fresh int64
array, never a view of the pinned buffer the next wave's read reuses.

The serve loop is single-threaded request/reply; the coordinator
pipelines by sending wave l+1 before collecting wave l's reply, and the
FIFO channel preserves matching. Deterministic fault injection
(``inject``) arms process death on the nth matching op — the chaos
tests' worker-kill mechanism, mirroring ``repro_torch.fault.failures``.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.mining.distributed import protocol as pr
from repro_torch.mining.distributed.transport import dial


class _FaultPlan:
    """Die on the nth request whose op matches (before serving it, or
    right after the reply flushes)."""

    def __init__(self, op: str, after: int = 0, when: str = "before"):
        self.op = op
        self.remaining = int(after)
        self.when = when

    def matches(self, op: str) -> bool:
        if op != self.op:
            return False
        if self.remaining > 0:
            self.remaining -= 1
            return False
        return True


class Worker:
    """One TaskTracker: segments, wave state, and the serve loop."""

    def __init__(self, worker_id: int, *, device, n_items: int, spec, row_pad: int,
                 snapshot_dir: str | None):
        # imports deferred past process start so spawn cost is visible in
        # one place; torch (and CUDA) initialize here, inside the worker
        from repro_torch.mining.engine import MiningEngine

        self.worker_id = worker_id
        self.n_items = int(n_items)
        self.row_pad = int(row_pad)
        self.engine = MiningEngine(device=device, snapshot_dir=snapshot_dir)
        self._fe = self.engine.frontend("hprepost")
        self.device_cfg = self._fe._device_config(spec)
        self.miner = self._fe.miner_for(spec)
        self.segments: dict[int, object] = {}  # seg_id -> stream.Segment
        self._executor = None
        self._query_segs: list = []
        self._fault: _FaultPlan | None = None
        self.stats = {
            "seg_prepares": 0,
            "seg_snapshot_hits": 0, "seg_snapshot_misses": 0,
            "seg_snapshot_spill_failures": 0,
            "preps": 0, "waves": 0, "queries": 0,
        }

    # ------------------------------------------------------------------ ops
    def _op_prep(self, msg):
        from repro_torch.core import encoding as enc
        from repro_torch.mining.stream.stream import build_segment

        rows = np.asarray(msg["rows"], np.int32)
        local_items = np.asarray(msg["local_items"], np.int32)
        hist = enc.item_support(rows, self.n_items)  # on the host: no B3
        seg, source = build_segment(
            self.miner, self.engine.snapshot_store, self.n_items,
            rows, int(msg["n_rows_real"]), hist, local_items,
            seg_id=int(msg["seg_id"]), device_cfg=self.device_cfg,
            row_pad=self.row_pad, stats=self.stats,
        )
        self.segments[seg.seg_id] = seg
        self.stats["preps"] += 1
        return {
            "C": np.asarray(seg.prepared.C),  # host NumPy already
            "source": source,
            "nbytes": int(seg.nbytes),
            "prep_bytes": int(seg.prepared.prep_bytes),
        }

    def _op_drop(self, msg):
        for sid in msg["seg_ids"]:
            self.segments.pop(int(sid), None)
        return {}

    def _op_query_begin(self, msg):
        from repro_torch.core.hprepost import LocalSegmentExecutor
        from repro_torch.mining.stream.segmented import segment_handles

        order_arr = np.asarray(msg["items"], np.int32)
        self._query_segs = [self.segments[sid] for sid in sorted(self.segments)]
        handles = segment_handles(self._query_segs, order_arr)
        self._executor = LocalSegmentExecutor(self.miner, handles)
        self._executor.begin()
        self.stats["queries"] += 1
        return {"segments": len(handles)}

    def _op_wave(self, msg):
        ex = self._executor
        if ex is None:
            raise RuntimeError("wave before query_begin")
        token = ex.dispatch(
            int(msg["level"]), np.asarray(msg["idx"], np.int64),
            np.asarray(msg["live"]), bool(msg["local"]),
        )
        sups = ex.collect(token)
        self.stats["waves"] += 1
        return {"sups": sups, "state_bytes": int(ex.state_bytes)}

    def _op_query_end(self, msg):
        self._executor = None
        self._query_segs = []
        return {}

    def _op_stats(self, msg):
        from repro_torch import kernels

        return {
            "stats": dict(self.stats),
            "segments": sorted(self.segments),
            "bytes": sum(s.nbytes for s in self.segments.values()),
            "launches": kernels.launches(),
        }

    def _op_inject(self, msg):
        self._fault = _FaultPlan(
            msg["fault_op"], after=int(msg.get("after", 0)),
            when=msg.get("when", "before"),
        )
        return {}

    # ------------------------------------------------------------- serving
    def serve(self, chan, *, idle_timeout_s: float = 30.0) -> None:
        handlers = {
            pr.OP_PREP: self._op_prep,
            "drop": self._op_drop,
            pr.OP_QUERY_BEGIN: self._op_query_begin,
            pr.OP_WAVE: self._op_wave,
            pr.OP_QUERY_END: self._op_query_end,
            pr.OP_PING: lambda msg: {},
            pr.OP_STATS: self._op_stats,
            pr.OP_INJECT: self._op_inject,
        }
        parent = os.getppid()
        while True:
            # idle-poll rather than block forever: the bounded recv
            # timeout lets a silently-dropped coordinator surface through
            # TCP keepalive as ConnectionClosed (the worker then exits via
            # worker_main) and gives us a beat to notice our parent died
            # without ever sending a FIN (kill -9 on the whole process
            # group leaves no one to close the socket; reparenting is the
            # one signal that always arrives)
            try:
                msg = chan.recv(idle_timeout_s)
            except TimeoutError:
                if os.getppid() != parent:  # reparented: coordinator is gone
                    return
                continue
            op = msg["op"]
            die_after = False
            if self._fault is not None and self._fault.matches(op):
                if self._fault.when == "before":
                    os._exit(1)  # SIGKILL-equivalent: no reply, no cleanup
                die_after = True
            if op == pr.OP_SHUTDOWN:
                chan.send({"seq": msg["seq"], "ok": True})
                return
            try:
                body = handlers[op](msg)
                reply = {"seq": msg["seq"], "ok": True, **body}
            except Exception as e:  # report, keep serving
                reply = {"seq": msg["seq"], "ok": False, "error": repr(e)}
            chan.send(reply)
            if die_after:
                os._exit(1)


def worker_main(address, worker_id: int, device, n_items: int, spec, row_pad: int,
                snapshot_dir: str | None) -> None:
    """Process entry point (multiprocessing spawn target): bind ``device``,
    dial the coordinator, introduce ourselves, serve until shutdown or
    death. A worker asked for CUDA where there is none raises here, before
    it dials: it never serves from the CPU."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    chan = dial(tuple(address))
    chan.send({"op": pr.OP_HELLO, "worker_id": worker_id, "pid": os.getpid()})
    w = Worker(worker_id, device=dev, n_items=n_items, spec=spec, row_pad=row_pad,
               snapshot_dir=snapshot_dir)
    try:
        w.serve(chan)
    except pr.ConnectionClosed:
        pass  # coordinator went away: nothing to serve
    finally:
        chan.close()
