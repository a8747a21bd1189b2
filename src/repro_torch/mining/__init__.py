"""repro_torch.mining — the front door to the port's miners.

    from repro_torch.mining import MineSpec, mine

    res = mine(rows, n_items, MineSpec(algorithm="hprepost", min_sup=0.3))
    res.itemsets, res.total_count, res.wall_time_s, res.stage_times_s

Registered algorithms: ``hprepost`` (the paper's miner, on a torch device),
``prepost`` / ``prepost+`` and ``bruteforce`` (host, test oracle). New
miners join via ``@register_miner("name")``.

``mine`` calls the registered frontend directly; a one-shot answer is the
same as through the reference's ``MiningEngine``, which is not ported yet.
"""
from repro_torch.mining import miners as _miners  # noqa: F401  (populates the registry)
from repro_torch.mining.registry import Miner, get_miner, list_miners, register_miner
from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import PATTERN_KINDS, MineSpec


def mine(rows, n_items: int, spec: MineSpec | None = None, device=None,
         **spec_kwargs) -> MineResult:
    """One-shot front door: ``mine(rows, n_items, MineSpec(...))`` or
    ``mine(rows, n_items, algorithm="prepost", min_sup=0.3)``. ``device``
    defaults to CUDA for the device miners (``hprepost``), which raise when
    none is present unless ``device="cpu"``."""
    if spec is None:
        spec = MineSpec(**spec_kwargs)
    elif spec_kwargs:
        raise TypeError("pass a MineSpec or spec kwargs, not both")
    return get_miner(spec.algorithm, device=device).mine(rows, n_items, spec)


__all__ = [
    "MineSpec",
    "MineResult",
    "Miner",
    "PATTERN_KINDS",
    "get_miner",
    "list_miners",
    "mine",
    "register_miner",
]
