"""repro_torch.mining.service — the resident mining service layer.

Four modules on top of ``MiningEngine``, as in the reference:

  ``store``      cross-process persistence: a content-addressed on-disk
                 snapshot store of serialized PreparedDBs (the reference's
                 layout), so a cold process warm-starts with zero prep
  ``admission``  backpressure: the bounded admission queue (depth +
                 in-flight byte budgets, oldest-deadline-first shedding)
                 and the typed service errors ``Overloaded`` /
                 ``DeadlineExceeded`` / ``ServiceClosed``
  ``scheduler``  async execution across *groups*: group g+1's prepare runs
                 on a prep thread — on CUDA, on a stream of its own —
                 while group g's waves drain; host algorithms run on
                 worker threads alongside; priority ordering + deadline
                 drops
  ``service``    the ``MiningService`` facade: ``submit() -> Future``, a
                 batching window that coalesces concurrent requests into
                 planned groups, crash-proof worker loop, graceful
                 drain-or-fail close, per-request telemetry

``MiningService``/``GroupScheduler`` are imported lazily: the engine
itself constructs a ``SnapshotStore`` (warm-start hooks), and an eager
import here would cycle back through ``repro_torch.mining.engine``.
"""
from repro_torch.mining.service.admission import (
    AdmissionQueue, DeadlineExceeded, Overloaded, ServiceClosed, ServiceError,
)
from repro_torch.mining.service.store import SnapshotStore

__all__ = [
    "AdmissionQueue", "DeadlineExceeded", "GroupScheduler", "MiningService",
    "Overloaded", "ServiceClosed", "ServiceError", "SnapshotStore",
]


def __getattr__(name: str):
    if name == "MiningService":
        from repro_torch.mining.service.service import MiningService

        return MiningService
    if name == "GroupScheduler":
        from repro_torch.mining.service.scheduler import GroupScheduler

        return GroupScheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
