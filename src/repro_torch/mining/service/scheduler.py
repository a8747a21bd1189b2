"""GroupScheduler: overlapped execution across planned groups, on one
torch device or a mesh of them.

The miner software-pipelines the wave loop *within* one group (wave l+1
dispatched before wave l's supports land). This lifts the same idea one
level up:

  - hprepost requests are grouped exactly like ``MiningEngine.
    submit_many`` (database fingerprint + device config), but group g+1's
    *prepare* — Jobs 1/2, pack and F2 — is dispatched on a dedicated prep
    thread while group g's k>2 wave loop is still draining on the caller
    thread. One prep thread keeps device pressure bounded and preserves
    group order.
  - host-algorithm requests (apriori / fpgrowth / prepost / ...) carry no
    device state at all; they run on a small worker pool fully concurrent
    with the device groups.

Unlike ``submit_many``, singleton hprepost groups stay *groups* here: two
back-to-back requests on two distinct databases are precisely the case
where overlapping prepare(g+1) with mine(g) pays.

QoS: within one batch, device groups are served highest ``spec.priority``
first (max over the group's members; FIFO between equals), and any
request whose ``deadline_at`` has already passed is dropped with a typed
``DeadlineExceeded`` *before* its device work — checked at classification
and again right before its group serves, so a deadline that expires while
earlier groups drain still saves the work.

On CUDA the overlap needs streams, which the reference (whose dispatch is
thread-safe and has no user-visible streams) does not have:

  - Streams. Every PyTorch thread starts on the device's default stream,
    so a prep thread and a serving thread sharing it would have the card
    run their work in series, and ``prepare``'s host reads (``hist.cpu()``,
    ``C.cpu()``) would wait behind the other group's queued waves. The prep
    thread therefore runs ``engine._group_acquire`` with its own stream
    current on every CUDA device of the engine (``prep_streams``, one per
    distinct device of its mesh); the serving thread waves on its own
    current streams. The kernel wrappers launch on the current stream and
    the miner's ``_HostRead`` records its events there, so nothing below
    this module changes.
  - Hand-off. An acquire ends by recording an event on each prep stream,
    and each device's serving stream waits on its event before the group's
    first wave. That
    ``prepare`` happens to synchronise its last stage through ``C.cpu()``
    is no contract: it does not hold for a K <= 1 prepare, nor for a
    ``cache`` or ``snapshot`` acquire, whose host-to-device copy is queued
    on the prep stream.
  - Lifetime. The serving streams ``record_stream`` the PreparedDB's
    device tensors (``packed``, one per data shard) before reading them.
    The blocks were allocated on the prep streams; without the mark, an LRU
    eviction (or a later prep on a prep stream) could have the caching
    allocator hand one out again while this group's waves still read it.
  - The CPU has no streams: the same code runs with the stream steps
    skipped (the path the tests take). Nothing falls back: a failed
    acquire or serve resolves that group's slots with its error.

Results preserve request order. With ``return_exceptions=True`` a failed
request yields its exception object in the result slot (the service maps
those onto per-request futures); otherwise the first failure raises.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.device import on_streams, record_ready, side_streams, wait_ready
from repro_torch.mining.engine import MineRequest, MiningEngine
from repro_torch.mining.service.admission import DeadlineExceeded
from repro_torch.mining.telemetry import trace


class GroupScheduler:
    """Overlapped batch executor over one (thread-safe) ``MiningEngine``.

    ``overlap=False`` degrades to strictly sequential group execution on
    the calling thread's stream — the baseline overlap is compared with.
    """

    def __init__(self, engine: MiningEngine, *, host_workers: int = 4, overlap: bool = True):
        self.engine = engine
        self.telemetry = engine.telemetry  # shared latency registry
        self.overlap = overlap
        # the prep thread's own streams, one per CUDA device of the engine
        # (none on the CPU; see the module docstring)
        self.prep_streams = side_streams(engine.devices())
        self._host_pool = ThreadPoolExecutor(
            max_workers=max(1, host_workers), thread_name_prefix="mine-host"
        )
        self._prep_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mine-prep")
        self._stats_lock = threading.Lock()  # counters touched off-thread
        self.stats = {
            "batches": 0,
            "device_groups": 0,
            "host_requests": 0,
            # prepares that ran while an earlier group was still mining
            "overlapped_prepares": 0,
            "degraded_groups": 0,  # group floor tripped a guard -> per-request
            # requests resolved with DeadlineExceeded before device work
            "deadline_dropped": 0,
            # batches whose group order differed from FIFO due to priority
            "priority_reordered": 0,
        }

    def close(self) -> None:
        self._prep_pool.shutdown(wait=True)
        self._host_pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ run
    def run(self, requests, *, return_exceptions: bool = False) -> list:
        """Serve a batch; results align with the input order.

        Device groups run in submission order on the calling thread with
        their prepares pipelined one group ahead; host requests resolve on
        the worker pool whenever they finish."""
        requests: list[MineRequest] = list(requests)
        results: list = [None] * len(requests)
        groups: list[tuple[tuple, list[int]]] = []
        by_key: dict[tuple, int] = {}
        host_futures: list[tuple[int, object]] = []
        self.stats["batches"] += 1

        trace_root = next(
            (r.trace_id for r in requests if r.trace_id is not None), None
        )
        with trace.span("group.classify", parent=trace_root, n=len(requests)):
            for i, r in enumerate(requests):
                if self._expired(r):  # dead on arrival: no classification work
                    results[i] = self._drop(r)
                    continue
                key = self.engine._plan_key(r)
                if key is None:
                    self.stats["host_requests"] += 1
                    host_futures.append((i, self._submit_host(r)))
                elif key in by_key:
                    groups[by_key[key]][1].append(i)
                else:
                    by_key[key] = len(groups)
                    groups.append((key, [i]))
        self.stats["device_groups"] += len(groups)

        # highest-priority group first (max over members; stable, so equal
        # priorities keep FIFO order)
        order = sorted(
            range(len(groups)),
            key=lambda g: -max(requests[i].spec.priority for i in groups[g][1]),
        )
        if order != sorted(order):
            self.stats["priority_reordered"] += 1
        groups = [groups[g] for g in order]

        # pipeline, one group ahead: group g+1's acquire is handed to the
        # prep thread right before group g's waves start draining here, so
        # exactly one prepare overlaps the mining and at most two
        # PreparedDBs are pinned on the device at once
        group_reqs = [[requests[i] for i in idxs] for _, idxs in groups]
        ahead = None
        if self.overlap and groups:
            ahead = self._submit_prep(group_reqs[0], groups[0][0])
        for gi, (key, idxs) in enumerate(groups):
            reqs = group_reqs[gi]
            acq_fut, ahead = ahead, None
            if self.overlap and gi + 1 < len(groups):
                ahead = self._submit_prep(group_reqs[gi + 1], groups[gi + 1][0])
            group_root = next(
                (r.trace_id for r in reqs if r.trace_id is not None), None
            )
            t_acq = time.perf_counter()
            try:
                with trace.span("group.prep", parent=group_root,
                                overlapped=acq_fut is not None and gi > 0):
                    acq, ready = acq_fut.result() if acq_fut is not None \
                        else (self.engine._group_acquire(reqs, key), None)
                # wait observed by the serving thread: ~0 when the prep
                # pipelined ahead (the actual build cost is engine.prep_s)
                self.telemetry.histogram("scheduler.prep_wait_s").record(
                    time.perf_counter() - t_acq
                )
            except ValueError:
                # group-floor guard trip: degrade to per-request one-shots,
                # so a real per-request error surfaces on its own request
                self.stats["degraded_groups"] += 1
                for i, res in zip(idxs, [self._one(r) for r in reqs]):
                    results[i] = res
                continue
            except Exception as e:
                # any other acquire failure belongs to THIS group's slots,
                # not to the batch: other groups and host requests proceed
                for i in idxs:
                    results[i] = e
                continue
            # deadline recheck at serve time: members whose deadline passed
            # while earlier groups drained are dropped without device work
            live: list[tuple[int, MineRequest]] = []
            for i, r in zip(idxs, reqs):
                if self._expired(r):
                    results[i] = self._drop(r)
                else:
                    live.append((i, r))
            if not live:
                continue
            overlapped = self.overlap and acq[2] == "built" and gi > 0
            if overlapped:
                self.stats["overlapped_prepares"] += 1
            live_reqs = [r for _, r in live]
            t_serve = time.perf_counter()
            try:
                self._hand_off(acq, ready)
                with trace.span("group.serve", parent=group_root,
                                n=len(live_reqs), source=acq[2]):
                    group_out = self.engine._group_serve(live_reqs, acq)
                for res in group_out:
                    res.service_stats["prep_overlapped"] = overlapped
            except Exception as e:  # serve failure: pin it to every member
                group_out = [e] * len(live_reqs)
            self.telemetry.histogram("scheduler.serve_s").record(
                time.perf_counter() - t_serve
            )
            for (i, _), res in zip(live, group_out):
                results[i] = res

        for i, fut in host_futures:
            results[i] = fut.result()  # _one never raises; errors are values

        if not return_exceptions:
            for res in results:
                if isinstance(res, BaseException):
                    raise res
        return results

    # ---------------------------------------------------------------- streams
    def _acquire_on_prep_stream(self, reqs, key):
        """The prep thread's job: ``engine._group_acquire`` on the prep
        streams -> ``(acq, ready)``, ``ready`` the ``(device, event)`` pairs
        recorded after the acquire's last device work (None off CUDA)."""
        with on_streams(self.prep_streams):
            acq = self.engine._group_acquire(reqs, key)
            ready = record_ready(self.prep_streams)
        return acq, ready

    def _hand_off(self, acq, ready) -> None:
        """Order the serving streams after the acquire (``ready``) and mark
        the PreparedDB's device tensors as in use on them, so the allocator
        cannot reuse their blocks before this group's waves are done."""
        if ready is None:
            return
        wait_ready(ready)
        for t in acq[1].packed or ():
            t.record_stream(torch.cuda.current_stream(t.device))

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _expired(r: MineRequest) -> bool:
        return r.deadline_at is not None and time.monotonic() > r.deadline_at

    def _drop(self, r: MineRequest) -> DeadlineExceeded:
        with self._stats_lock:
            self.stats["deadline_dropped"] += 1
        return DeadlineExceeded(
            f"deadline_s={r.spec.deadline_s} passed before mining started"
        )

    class _Done:
        """Pre-resolved stand-in for a pool future (pool already shut down)."""

        def __init__(self, value):
            self._value = value

        def result(self):
            return self._value

    def _submit_host(self, r: MineRequest):
        """Submit ``_one`` to the host pool; a dead/shut-down pool degrades
        to inline execution instead of killing the batch."""
        try:
            return self._host_pool.submit(self._one, r)
        except RuntimeError:
            return self._Done(self._one(r))

    def _submit_prep(self, reqs, key):
        """Submit a group acquire to the prep thread; None when the pool is
        dead (the caller then acquires inline — slower, never wrong)."""
        try:
            return self._prep_pool.submit(self._acquire_on_prep_stream, reqs, key)
        except RuntimeError:
            return None

    def _one(self, r: MineRequest):
        """One-shot submit with the error held as a value (so a failing
        request costs its own slot, never the batch)."""
        if self._expired(r):  # checked at execution, not submission: a host
            return self._drop(r)  # request can expire waiting for a pool slot
        t0 = time.perf_counter()
        try:
            with trace.span("host.mine", parent=r.trace_id,
                            algorithm=r.spec.algorithm):
                return self.engine.submit(r.rows, r.n_items, r.spec)
        except Exception as e:
            return e
        finally:
            self.telemetry.histogram("scheduler.host_s").record(
                time.perf_counter() - t0
            )
