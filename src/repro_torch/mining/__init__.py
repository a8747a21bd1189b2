"""repro_torch.mining — the front door to the port's miners.

    from repro_torch.mining import MineSpec, mine

    res = mine(rows, n_items, MineSpec(algorithm="hprepost", min_sup=0.3))
    res.itemsets, res.total_count, res.wall_time_s, res.stage_times_s

    # resident session (resident miners across submits); threshold sweeps
    # are planned — prep stages run once at the loosest threshold and every
    # min_sup is served from the shared PreparedDB:
    from repro_torch.mining import MiningEngine
    eng = MiningEngine(device="cuda")
    results = eng.sweep(rows, n_items, MineSpec(max_k=5), [0.4, 0.3, 0.2])

Registered algorithms: ``hprepost`` (the paper's miner, on a torch device),
``prepost`` / ``prepost+``, ``fpgrowth``, ``apriori``, ``bruteforce``
(test oracle). New miners join via ``@register_miner("name")``.

The serving layer lives in ``repro_torch.mining.service`` (re-exported
lazily from here): ``MiningService`` (submit -> Future, batching window,
drain), ``GroupScheduler`` (cross-group prepare/mine overlap, the prepare
on a CUDA stream of its own) and ``SnapshotStore`` (cross-process
PreparedDB persistence; also reachable as ``MiningEngine(snapshot_dir=...)``).
The streaming layer, ``repro_torch.mining.stream`` (``StreamSpec``,
``StreamingMiner``, re-exported lazily), and continuous mining,
``repro_torch.mining.continuous``, are reached through
``MiningEngine.append`` / ``submit_stream`` / ``register_standing``.
"""
import torch

from repro_torch.mining.engine import MineRequest, MiningEngine
from repro_torch.mining import miners as _miners  # noqa: F401  (populates the registry)
from repro_torch.mining.registry import Miner, get_miner, list_miners, register_miner
from repro_torch.mining.result import MineResult
from repro_torch.mining.service import SnapshotStore
from repro_torch.mining.spec import PATTERN_KINDS, MineSpec

# one process-wide default engine per device, built on first use
_default_engines: dict[torch.device, MiningEngine] = {}


def mine(rows, n_items: int, spec: MineSpec | None = None, device=None,
         **spec_kwargs) -> MineResult:
    """One-shot front door: ``mine(rows, n_items, MineSpec(...))`` or
    ``mine(rows, n_items, algorithm="prepost", min_sup=0.3)``.

    Routed through a process-wide default ``MiningEngine`` for ``device``
    (CUDA when None), so repeated calls reuse its resident miners and
    cached PreparedDBs. The device miners (``hprepost``) raise when there is
    no CUDA device unless ``device="cpu"``; host miners ignore it."""
    if spec is None:
        spec = MineSpec(**spec_kwargs)
    elif spec_kwargs:
        raise TypeError("pass a MineSpec or spec kwargs, not both")
    dev = torch.device("cuda" if device is None else device)
    engine = _default_engines.get(dev)
    if engine is None:
        engine = _default_engines.setdefault(dev, MiningEngine(device=dev))
    return engine.submit(rows, n_items, spec)


__all__ = [
    "GroupScheduler",
    "MineSpec",
    "MineResult",
    "MineRequest",
    "Miner",
    "MiningEngine",
    "MiningService",
    "PATTERN_KINDS",
    "SnapshotStore",
    "StreamSpec",
    "StreamingMiner",
    "get_miner",
    "list_miners",
    "mine",
    "register_miner",
]


def __getattr__(name: str):
    # the serving and streaming layers spin thread pools and import back
    # through this package: loaded on first touch, not by a bare
    # ``import repro_torch.mining``
    if name in ("MiningService", "GroupScheduler"):
        import repro_torch.mining.service as _service

        return getattr(_service, name)
    if name in ("StreamSpec", "StreamingMiner"):
        import repro_torch.mining.stream as _stream

        return getattr(_stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
