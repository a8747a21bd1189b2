"""MiningService: the resident serving facade over engine + scheduler.

The paper's HPrepost amortizes MapReduce job setup across many queries on
one long-lived cluster; this is that posture as a process-local service on
one torch device. One worker thread owns execution: ``submit`` enqueues a
request and returns a ``concurrent.futures.Future`` immediately, the
worker coalesces every request that arrives within a small batching window
into one batch, and the batch is planned into shared-prep groups and
executed with cross-group overlap by the ``GroupScheduler`` (on CUDA, each
prepare on the scheduler's own stream). With a ``snapshot_dir`` bound, the
engine underneath warm-starts from (and spills to) the persistent
PreparedDB store, so a freshly started service serves a known database
with zero prep stages.

The invariant is *every accepted Future resolves*, with a result or a
typed error, whatever fails:

  - Admission control: ``max_queue_depth`` / ``max_queue_bytes`` bound the
    queue (``repro_torch.mining.service.admission``). A request that does
    not fit resolves immediately with ``Overloaded`` — backpressure, not
    silent buffering — and when the incoming deadline is later than a
    queued one, the oldest-deadline request is shed instead.
  - QoS: ``spec.priority`` orders device groups, ``spec.deadline_s``
    drops late requests with ``DeadlineExceeded`` before device work
    (both enforced by the scheduler; stream operations check their
    deadline right before executing).
  - Crash-proof worker: any batch-serving failure (prep-thread death,
    executor shutdown, chaos injection) resolves every Future the batch
    owns with that error and the loop continues (``worker_restarts``
    counts them). If the loop itself ever exits, still-queued requests
    are failed with ``ServiceClosed`` — no orphaned Futures, ever.

Telemetry rides each ``MineResult.service_stats``: queue time, batch
size, where the prep came from (built / LRU cache / snapshot) and whether
it overlapped an earlier group's mining. ``stats`` stays the counter dict
*and* is callable: ``service.stats()`` returns the full operator snapshot
(admission/shed/deadline counters, scheduler + engine + per-stream stats,
latency histograms). ``drain()`` blocks until every accepted request has
resolved; ``close()`` drains — or, with ``drain=False``, fails queued
requests with ``ServiceClosed`` — and stops the worker (also a context
manager).

Streaming traffic (``repro_torch.mining.stream``) rides the same queue:
``append``, ``submit_stream``, ``register_standing`` and
``cancel_standing`` return Futures and execute on the worker thread, in
arrival order relative to everything in their batch, so a query submitted
after an append is guaranteed to see the new segment. On CUDA they run on
the worker thread's current stream, between the scheduler's mining
chunks. ``distribute`` opens a distributed database on the engine; its
``append`` / ``submit_stream`` then ride the same lane, worker failover
included.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Sequence

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fault import failures
from repro_torch.mining.engine import MineRequest, MiningEngine
from repro_torch.mining.result import MineResult
from repro_torch.mining.service.admission import (
    AdmissionQueue, DeadlineExceeded, Overloaded, ServiceClosed,
)
from repro_torch.mining.service.scheduler import GroupScheduler
from repro_torch.mining.spec import MineSpec
from repro_torch.mining.telemetry import trace


@dataclasses.dataclass(eq=False)  # identity ==: AdmissionQueue removes by it,
class _Pending:                   # and field-wise eq chokes on array payloads
    req: MineRequest | None  # None for stream operations
    future: Future
    submitted_at: float
    deadline_at: float | None = None  # monotonic instant; admission + QoS
    priority: int = 0
    nbytes: int = 0  # admission byte accounting (rows payload)
    released: bool = False  # accounting done exactly once (see _finish)
    trace_id: int | None = None  # root span id when a tracer is attached
    kind: str = "mine"  # "mine" | "stream" (append / stream query / standing)
    run: object = None  # stream ops: zero-arg callable executed in order


class _ServiceStats(dict):
    """``service.stats`` — the counter dict, also callable:
    ``service.stats()`` returns the merged operator snapshot."""

    def __init__(self, snapshot, **counters):
        super().__init__(**counters)
        self._snapshot = snapshot

    def __call__(self) -> dict:
        return self._snapshot()


class MiningService:
    """Async front-door: ``submit() -> Future[MineResult]``.

    ``device`` binds the engine's torch device: CUDA by default, raising
    when there is none (``device="cpu"`` runs the kernels' plain versions).
    ``mesh`` binds a mesh of devices instead (``MiningEngine(mesh=...)``).
    ``batch_window_s`` is the coalescing window: once a request arrives,
    the worker keeps collecting for that long so concurrent callers land
    in one planned batch (sweep requests on one database become one
    shared-prep group; distinct databases become pipelined groups). 0
    serves strictly one request per batch.

    ``max_queue_depth`` / ``max_queue_bytes`` bound admission (None =
    unbounded): depth counts queued requests, bytes count the ``rows``
    payload of everything admitted but not yet resolved. Requests that do
    not fit resolve with ``Overloaded``.
    """

    def __init__(self, engine: MiningEngine | None = None, *, device=None, mesh=None,
                 snapshot_dir: str | None = None, batch_window_s: float = 0.02,
                 host_workers: int = 4, max_queue_depth: int | None = None,
                 max_queue_bytes: int | None = None, **engine_kwargs):
        if engine is not None and (device is not None or mesh is not None
                                   or snapshot_dir is not None or engine_kwargs):
            raise ValueError("pass an engine or engine-construction kwargs, not both")
        self.engine = engine if engine is not None else MiningEngine(
            resolve_device(device) if mesh is None else device, mesh=mesh,
            snapshot_dir=snapshot_dir, **engine_kwargs,
        )
        self.scheduler = GroupScheduler(self.engine, host_workers=host_workers)
        self.batch_window_s = float(batch_window_s)
        self.stats = _ServiceStats(
            self._stats_snapshot,
            requests=0, batches=0, max_batch=0,
            worker_restarts=0,  # batches whose serve crashed (loop survived)
            stream_deadline_dropped=0,  # stream ops expired before running
        )
        self._q = AdmissionQueue(
            max_depth=max_queue_depth, max_bytes=max_queue_bytes,
            registry=self.engine.telemetry,
        )
        self._cv = threading.Condition()
        self._outstanding = 0
        self._closed = False
        self._worker_dead = False
        self._worker = threading.Thread(
            target=self._loop, name="mining-service", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------ submission
    def submit(self, rows, n_items: int, spec: MineSpec) -> Future:
        """Enqueue one request; the Future resolves to its ``MineResult``
        (or raises what the request raised — including the typed admission
        errors ``Overloaded`` / ``DeadlineExceeded``)."""
        arr = np.asarray(rows)
        deadline_at = (
            time.monotonic() + spec.deadline_s if spec.deadline_s is not None else None
        )
        return self._enqueue(_Pending(
            MineRequest(rows, n_items, spec, deadline_at=deadline_at),
            Future(), time.monotonic(),
            deadline_at=deadline_at, priority=spec.priority, nbytes=int(arr.nbytes),
        ))

    def submit_many(self, requests: Sequence[MineRequest]) -> list[Future]:
        return [self.submit(r.rows, r.n_items, r.spec) for r in requests]

    def _submit_stream_op(self, run, *, spec: MineSpec | None = None,
                          nbytes: int = 0) -> Future:
        deadline_at = (
            time.monotonic() + spec.deadline_s
            if spec is not None and spec.deadline_s is not None else None
        )
        return self._enqueue(_Pending(
            None, Future(), time.monotonic(), kind="stream", run=run,
            deadline_at=deadline_at,
            priority=spec.priority if spec is not None else 0,
            nbytes=int(nbytes),
        ))

    def _enqueue(self, p: _Pending) -> Future:
        """Admission: the closed/dead check, the chaos point, and the queue
        offer are one atomic step under ``_cv`` — a request is either
        rejected here or guaranteed to be observed by the worker (or by
        the worker's exit drain). Every path returns a Future that WILL
        resolve."""
        shed: list[_Pending] = []
        admitted = False
        enq_err: BaseException | None = None
        with self._cv:
            if self._closed or self._worker_dead:
                raise ServiceClosed("MiningService is closed")
            try:
                failures.fire("service.enqueue")
            except BaseException as e:
                enq_err = e
            else:
                admitted, shed = self._q.offer(p)
                if admitted:
                    self._outstanding += 1
                    self.stats["requests"] += 1
        rec = trace.active()
        if admitted and rec is not None:
            # the request's root span: opened at submit time, closed when
            # its Future resolves in _serve (or on a crashed batch)
            p.trace_id = rec.open(
                "request", t0=p.submitted_at, kind=p.kind, priority=p.priority
            )
            if p.req is not None:
                p.req.trace_id = p.trace_id
        # resolve losers outside the lock (their callbacks run inline)
        for s in shed:
            if rec is not None and s.trace_id is not None:
                rec.close(s.trace_id, error="shed")
            self._resolve_exc(s.future, Overloaded(
                "request shed from the admission queue by later-deadline work",
                shed=True, depth=self._q.depth,
                bytes_in_flight=self._q.bytes_in_flight,
            ))
            # offer() already reclaimed shed bytes; only undo the counting
            self._finish(s, release_bytes=False)
        if enq_err is not None:
            self._resolve_exc(p.future, enq_err)
        elif not admitted:
            self._resolve_exc(p.future, Overloaded(
                "admission queue full "
                f"(max_depth={self._q.max_depth}, max_bytes={self._q.max_bytes})",
                depth=self._q.depth, bytes_in_flight=self._q.bytes_in_flight,
            ))
        return p.future

    def sweep(self, rows, n_items: int, spec: MineSpec,
              min_sups: Sequence[float]) -> list[Future]:
        """The paper's threshold sweep, submitted concurrently — the batch
        window coalesces it into one shared-prep group."""
        return [self.submit(rows, n_items, spec.with_(min_sup=s)) for s in min_sups]

    def append(self, rows, n_items: int | None = None, *, stream: str = "default",
               spec: MineSpec | None = None, stream_spec=None) -> Future:
        """Enqueue a streaming ingest (``engine.append``); the Future
        resolves to the append telemetry dict. Stream operations execute
        in arrival order relative to each other and to mining requests in
        the same batch, so a query submitted after an append observes it.

        The batch is copied HERE, at submit time — execution happens after
        the batching window, and a caller reusing its array for the next
        batch must not retroactively change what this one ingests."""
        rows = np.array(rows, np.int32, copy=True)
        return self._submit_stream_op(
            lambda: self.engine.append(
                rows, n_items, stream=stream, spec=spec, stream_spec=stream_spec
            ),
            nbytes=rows.nbytes,
        )

    def submit_stream(self, spec: MineSpec, *, stream: str = "default") -> Future:
        """Enqueue a query against the named stream's live ``SegmentedDB``;
        the Future resolves to its ``MineResult``."""
        return self._submit_stream_op(
            lambda: self.engine.submit_stream(spec, stream=stream), spec=spec
        )

    def register_standing(self, spec: MineSpec, *, stream: str = "default") -> Future:
        """Enqueue a standing-query registration on the named stream; the
        Future resolves to the ``StandingQuery`` handle (its initial
        answer already delivered as diff 0). Registration rides the same
        arrival-order stream lane as ``append``/``submit_stream``, so a
        query registered after an append observes it — and every
        subsequent append's diff is delivered before that append's own
        Future resolves."""
        return self._submit_stream_op(
            lambda: self.engine.register_standing(spec, stream=stream), spec=spec
        )

    def cancel_standing(self, query, *, stream: str = "default") -> Future:
        """Enqueue a standing-query cancellation (arrival order: diffs
        already in flight ahead of it still deliver)."""
        return self._submit_stream_op(
            lambda: self.engine.cancel_standing(query, stream=stream)
        )

    def distribute(self, name: str = "default", **kw):
        """Create/fetch a distributed database (``engine.distribute``) —
        synchronous, since it spawns worker processes, not a mining op.
        Once created, ``append`` / ``submit_stream`` on its name serve it
        through the ordinary Future path, worker failover included."""
        return self.engine.distribute(name, **kw)

    # ------------------------------------------------------------ accounting
    @staticmethod
    def _resolve_exc(fut: Future, exc: BaseException) -> None:
        """Resolve a Future with an error, tolerating a racing cancel —
        nothing here may throw, whatever state the caller drove it into."""
        try:
            fut.set_exception(exc)
        except InvalidStateError:
            pass

    def _finish(self, p: _Pending, *, release_bytes: bool = True) -> None:
        """Close out one accepted request's accounting, exactly once."""
        with self._cv:
            if p.released:
                return
            p.released = True
            self._outstanding -= 1
            self._cv.notify_all()
        if release_bytes:
            self._q.release(p.nbytes)

    def _stats_snapshot(self) -> dict:
        """The operator view: one dict merging every layer's counters.

        ``counters`` is the flat headline set (admitted / rejected / shed /
        deadline_dropped / retries / respawns); the nested sections carry
        each layer's full dict for drill-down. ``histograms`` is the shared
        telemetry registry's latency-distribution view (name -> count /
        sum / min / max / p50 / p95 / p99 / sparse buckets); ``telemetry``
        carries its counters, gauges, and schema version; ``streams`` each
        live stream's stats. ``retries`` / ``respawns`` sum the streams'
        ``rpc_retries`` / ``respawns``, which only distributed databases
        carry: 0 for local streams."""
        service = {k: v for k, v in self.stats.items()}
        streams = self.engine.stream_stats()
        adm = self._q.info()
        sched = dict(self.scheduler.stats)
        tel = self.engine.telemetry.snapshot()
        return {
            "histograms": tel["histograms"],
            "telemetry": {"schema": tel["schema"], "counters": tel["counters"],
                          "gauges": tel["gauges"]},
            "counters": {
                "admitted": adm["admitted"],
                "rejected": adm["rejected"],
                "shed": adm["shed"],
                "deadline_dropped": sched.get("deadline_dropped", 0)
                + service["stream_deadline_dropped"],
                "retries": sum(int(s.get("rpc_retries", 0)) for s in streams.values()),
                "respawns": sum(int(s.get("respawns", 0)) for s in streams.values()),
            },
            "service": service,
            "admission": adm,
            "scheduler": sched,
            "engine": {"stats": dict(self.engine.stats),
                       "cache": self.engine.cache_info()},
            "streams": streams,
        }

    # ------------------------------------------------------------- lifecycle
    def drain(self) -> None:
        """Block until every accepted request has resolved."""
        with self._cv:
            self._cv.wait_for(lambda: self._outstanding == 0 or self._worker_dead)

    def close(self, *, drain: bool = True) -> None:
        """Shutdown: stop accepting, then either drain (default — every
        accepted request resolves normally) or fail still-queued requests
        fast with ``ServiceClosed`` (``drain=False``; the batch already
        executing finishes either way), then stop the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
        if drain:
            self.drain()
        else:
            for p in self._q.drain_queued():
                self._resolve_exc(p.future, ServiceClosed(
                    "MiningService closed with drain=False while this request was queued"
                ))
                self._finish(p)
        self._q.put_sentinel()  # wake + stop the worker
        self._worker.join()
        self.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- worker loop
    def _loop(self) -> None:
        """Crash-proof batch loop: a serve failure resolves every Future
        the batch owns with that error and the loop continues. The exit
        drain in ``finally`` is the last line of the no-orphaned-Futures
        invariant — even an exit nothing anticipated fails what remains."""
        try:
            while True:
                batch, stop = self._collect()
                if batch:
                    try:
                        failures.fire("service.serve")  # chaos: worker death
                        self._serve(batch)
                    except BaseException as e:
                        self._fail_batch(batch, e)
                        with self._cv:
                            self.stats["worker_restarts"] += 1
                if stop:
                    return
        finally:
            self._worker_exited()

    def _collect(self) -> tuple[list[_Pending], bool]:
        """One batching window: ``(batch, stop)``. Empty batch + stop=False
        is the idle poll tick."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return [], False
        if first is None:
            return [], True
        batch = [first]
        deadline = time.monotonic() + self.batch_window_s
        while True:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                return batch, False
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                return batch, False
            if item is None:
                return batch, True
            batch.append(item)

    def _fail_batch(self, batch: list[_Pending], exc: BaseException) -> None:
        """Resolve every unresolved Future in a crashed batch with the
        crash. Futures ``_serve`` already resolved (or dropped as
        cancelled) are left alone — ``_finish`` is idempotent."""
        rec = trace.active()
        for p in batch:
            if not p.future.done():
                self._resolve_exc(p.future, exc)
            if rec is not None and p.trace_id is not None:
                rec.close(p.trace_id, error=repr(exc))
            self._finish(p)

    def _worker_exited(self) -> None:
        """The worker thread is gone for good: nothing will ever pop the
        queue again, so fail whatever is still on it."""
        with self._cv:
            self._worker_dead = True
            self._cv.notify_all()
        for p in self._q.drain_queued():
            self._resolve_exc(p.future, ServiceClosed(
                "service worker exited before this request ran"
            ))
            self._finish(p)

    def _serve(self, batch: list[_Pending]) -> None:
        t_start = time.monotonic()
        # transition every future to RUNNING; one the caller already
        # cancelled is dropped here (set_result on it would raise
        # InvalidStateError and kill the worker), and RUNNING futures can
        # no longer be cancelled out from under the batch
        live = []
        for p in batch:
            if p.future.set_running_or_notify_cancel():
                live.append(p)
            else:
                self._finish(p)
        batch = live
        if not batch:
            return
        self.stats["batches"] += 1
        self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
        rec = trace.active()
        if rec is not None:
            for p in batch:
                if p.trace_id is not None:
                    rec.add("admission.wait", p.submitted_at, t_start,
                            parent=p.trace_id)
        # execute in arrival order: contiguous runs of mining requests go
        # through the scheduler as one planned sub-batch, stream operations
        # (appends / stream queries / standing registrations) run inline
        # between them — a query that arrived after an append must observe
        # the appended segment
        results: list = [None] * len(batch)
        chunk: list[int] = []

        def flush_chunk():
            if not chunk:
                return
            try:
                out = self.scheduler.run(
                    [batch[j].req for j in chunk], return_exceptions=True
                )
            except BaseException as e:  # scheduler must not fail a batch silently
                out = [e] * len(chunk)
            for j, r in zip(chunk, out):
                results[j] = r
            chunk.clear()

        for i, p in enumerate(batch):
            if p.kind == "mine":
                chunk.append(i)
                continue
            flush_chunk()
            if p.deadline_at is not None and time.monotonic() > p.deadline_at:
                self.stats["stream_deadline_dropped"] += 1
                results[i] = DeadlineExceeded(
                    "deadline passed before the stream operation ran"
                )
                continue
            try:
                with trace.span("stream.op", parent=p.trace_id):
                    results[i] = p.run()
            except BaseException as e:
                results[i] = e
        flush_chunk()
        req_hist = self.engine.telemetry.histogram("service.request_s")
        for p, res in zip(batch, results):
            t_res = time.monotonic()
            if isinstance(res, BaseException):
                p.future.set_exception(res)
            else:
                if isinstance(res, MineResult):
                    res.service_stats.update(
                        queue_time_s=t_start - p.submitted_at, batch_size=len(batch)
                    )
                p.future.set_result(res)
            now = time.monotonic()
            req_hist.record(now - p.submitted_at)
            if rec is not None and p.trace_id is not None:
                rec.add("resolve", t_res, now, parent=p.trace_id,
                        ok=not isinstance(res, BaseException))
                rec.close(p.trace_id, t1=now)
            self._finish(p)
