"""Admission control for the resident mining service: bounded queues,
typed overload/deadline errors, and deadline-aware load shedding.

An unbounded queue is the failure mode every real serving stack hits
first: a traffic spike buffers silently until memory (or every caller's
patience) runs out. This module is the backpressure layer in front of the
service's worker loop (a copy of the reference's, pure Python):

  - ``AdmissionQueue``: a bounded FIFO with two independent budgets — a
    queue *depth* (requests waiting) and an *in-flight byte* budget
    (``rows`` bytes of every admitted-but-unresolved request, so a few
    huge databases can saturate the service as surely as many small
    ones). An offer that does not fit is REJECTED immediately — the
    caller's Future resolves with ``Overloaded`` now, instead of queueing
    into a timeout later.
  - Deadline-aware shedding: when the queue is full and the incoming
    request has a *later* deadline than some queued request, the queued
    request with the oldest (earliest) deadline is shed — it was the
    least likely to make its deadline anyway — and the newcomer is
    admitted. Requests without deadlines are never shed (treated as
    infinitely patient).
  - Typed errors: ``Overloaded`` / ``DeadlineExceeded`` / ``ServiceClosed``
    all subclass ``ServiceError``, so a caller can catch the service's
    own backpressure distinctly from a mining failure. The invariant the
    chaos harness enforces: every accepted Future resolves with a result
    or exactly one of these.

The queue stores the service's ``_Pending`` records; all it requires of
an item is ``nbytes`` and ``deadline_at`` attributes. Byte accounting is
*in-flight*, not just queued: ``offer`` charges, and the service's
``_finish`` (request resolved or failed) calls ``release`` — so the
budget also throttles work the batch window has already pulled off the
queue but not yet answered. Shed items are the one exception: ``offer``
reclaims their bytes itself, since they will never execute.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time


class ServiceError(RuntimeError):
    """Base of the service's own typed errors (vs. mining failures)."""


class Overloaded(ServiceError):
    """Admission refused: queue depth or in-flight byte budget exhausted.

    ``shed`` distinguishes a request rejected at the door (False) from an
    already-queued request evicted to admit later-deadline work (True).
    """

    def __init__(self, msg: str, *, shed: bool = False,
                 depth: int = 0, bytes_in_flight: int = 0):
        super().__init__(msg)
        self.shed = shed
        self.depth = depth
        self.bytes_in_flight = bytes_in_flight


class DeadlineExceeded(ServiceError):
    """The request's ``deadline_s`` passed before device work started."""


class ServiceClosed(ServiceError):
    """The service shut down (or its worker exited) before execution."""


def _eff(deadline_at: float | None) -> float:
    """Effective deadline for ordering: none = infinitely patient."""
    return float("inf") if deadline_at is None else deadline_at


class AdmissionQueue:
    """Bounded admission-controlled FIFO between ``submit`` and the worker.

    ``max_depth`` bounds queued (not yet batch-collected) requests;
    ``max_bytes`` bounds the *in-flight* byte total (queued + executing,
    until the owner calls ``release``). Either may be None (unbounded) —
    both None degrades to the old unbounded queue.
    """

    def __init__(self, *, max_depth: int | None = None,
                 max_bytes: int | None = None, registry=None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_depth = max_depth
        self.max_bytes = max_bytes
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._bytes_in_flight = 0
        self.counters = {"admitted": 0, "rejected": 0, "shed": 0}
        # telemetry: the service passes its engine's shared registry; a
        # standalone queue (unit tests) gets a private one. Instrument
        # locks are leaves — safe to touch while holding ``_cv``.
        if registry is None:
            from repro_torch.mining.telemetry import Registry

            registry = Registry()
        self.telemetry = registry
        self._depth_gauge = registry.gauge("admission.queue_depth")
        self._bytes_gauge = registry.gauge("admission.bytes_in_flight")
        self._wait_hist = registry.histogram("admission.queue_wait_s")

    def _update_gauges(self) -> None:
        # caller holds ``_cv``
        self._depth_gauge.set(sum(1 for it in self._items if it is not None))
        self._bytes_gauge.set(self._bytes_in_flight)

    # ------------------------------------------------------------- producer
    def offer(self, item) -> tuple[bool, list]:
        """Try to admit ``item``: ``(admitted, shed_items)``.

        May evict queued items (oldest effective deadline first) when that
        frees room AND every evicted deadline is strictly earlier than the
        incoming one. Shed items' bytes are reclaimed here (they will
        never execute); the caller owns resolving their Futures with
        ``Overloaded(shed=True)`` but must NOT ``release`` them again.
        """
        shed: list = []
        with self._cv:
            while self._over(item.nbytes):
                victim = self._sheddable(item)
                if victim is None:
                    self.counters["rejected"] += 1
                    return False, shed
                self._items.remove(victim)
                self._bytes_in_flight = max(0, self._bytes_in_flight - int(victim.nbytes))
                shed.append(victim)
                self.counters["shed"] += 1
            self._items.append(item)
            self._bytes_in_flight += int(item.nbytes)
            self.counters["admitted"] += 1
            self._update_gauges()
            self._cv.notify()
        return True, shed

    def _over(self, incoming_bytes: int) -> bool:
        # depth counts queued slots; bytes held by already-executing work
        # cannot be shed, so a byte-full service with an empty queue
        # rejects rather than evicts
        over_depth = self.max_depth is not None and len(self._items) + 1 > self.max_depth
        over_bytes = (
            self.max_bytes is not None
            and self._bytes_in_flight + int(incoming_bytes) > self.max_bytes
        )
        return over_depth or over_bytes

    def _sheddable(self, incoming):
        """The queued item to shed for ``incoming``, or None.

        Oldest-deadline-first: the queued item with the earliest effective
        deadline, and only if that deadline is strictly earlier than the
        incoming one — a full queue of no-deadline work rejects newcomers
        instead of churning."""
        victim = None
        for it in self._items:
            if victim is None or _eff(it.deadline_at) < _eff(victim.deadline_at):
                victim = it
        if victim is None or _eff(victim.deadline_at) >= _eff(incoming.deadline_at):
            return None
        return victim

    def put_sentinel(self) -> None:
        """Enqueue the worker-stop sentinel (bypasses admission)."""
        with self._cv:
            self._items.append(None)
            self._cv.notify()

    # ------------------------------------------------------------- consumer
    def get(self, timeout: float | None = None):
        """Pop the oldest entry (item or the None sentinel); raises
        ``queue.Empty`` on timeout — drop-in for the old SimpleQueue."""
        with self._cv:
            if not self._cv.wait_for(lambda: len(self._items) > 0, timeout):
                raise _queue.Empty
            item = self._items.popleft()
            self._update_gauges()
        if item is not None:
            submitted_at = getattr(item, "submitted_at", None)
            if submitted_at is not None:
                self._wait_hist.record(time.monotonic() - submitted_at)
        return item

    def release(self, nbytes: int) -> None:
        """Return ``nbytes`` to the in-flight budget (request resolved)."""
        with self._cv:
            self._bytes_in_flight = max(0, self._bytes_in_flight - int(nbytes))
            self._update_gauges()
            self._cv.notify_all()

    def drain_queued(self) -> list:
        """Remove and return every queued item (sentinels dropped) — the
        close-without-drain / worker-death path. The caller resolves their
        Futures and releases their bytes."""
        with self._cv:
            out = [it for it in self._items if it is not None]
            self._items.clear()
            self._update_gauges()
            return out

    # ------------------------------------------------------------ telemetry
    @property
    def depth(self) -> int:
        with self._cv:
            return sum(1 for it in self._items if it is not None)

    @property
    def bytes_in_flight(self) -> int:
        with self._cv:
            return self._bytes_in_flight

    def info(self) -> dict:
        with self._cv:
            return {
                **self.counters,
                "depth": sum(1 for it in self._items if it is not None),
                "bytes_in_flight": self._bytes_in_flight,
                "max_depth": self.max_depth,
                "max_bytes": self.max_bytes,
            }
