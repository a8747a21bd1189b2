"""repro_torch.mining.service — the serving layer over ``MiningEngine``.

``store``: cross-process persistence, a content-addressed on-disk snapshot
store of serialized PreparedDBs in the reference's layout, so a cold
process warm-starts with zero prep stages. The admission queue, scheduler
and ``MiningService`` come later.
"""
from repro_torch.mining.service.store import SnapshotStore

__all__ = ["SnapshotStore"]
