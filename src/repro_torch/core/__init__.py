"""Core of the paper's contribution: N-list frequent-itemset mining, on torch.

Public API — mine through the front door ``repro_torch.mining``
(re-exported here): ``MineSpec``, ``mine()`` / ``MiningEngine`` (one-shot
vs. resident session), and the ``register_miner`` registry covering
hprepost, prepost, prepost+, fpgrowth, apriori and the brute-force oracle.

Building blocks (importable directly):

  - encoding: transaction padding, F-list, rank encoding
  - ppc: sort-based PPC-tree (host and device construction)
  - nlist: N-list intersection (vectorized subsume test)
  - prepost: single-shard PrePost/PrePost+ miner (host)
  - hprepost: the MapReduce miner on one torch device
  - fpgrowth / apriori / oracle: comparators (host)
  - patterns: closed / maximal / top-rank-k post-passes
"""
from repro_torch.core.apriori import mine_apriori
from repro_torch.core.encoding import PAD, FList, build_flist, item_support, pad_transactions, rank_encode
from repro_torch.core.fpgrowth import mine_fpgrowth
from repro_torch.core.ppc import PPCTree, build_ppc
from repro_torch.core.prepost import mine_prepost

_MINING_EXPORTS = (
    "MineSpec",
    "MineResult",
    "MiningEngine",
    "mine",
    "get_miner",
    "list_miners",
    "register_miner",
)

__all__ = [
    "PAD",
    "FList",
    "build_flist",
    "item_support",
    "pad_transactions",
    "rank_encode",
    "PPCTree",
    "build_ppc",
    "mine_prepost",
    "mine_fpgrowth",
    "mine_apriori",
    *_MINING_EXPORTS,
]


def __getattr__(name):
    # Lazy re-export of the repro_torch.mining surface (PEP 562) — keeps
    # core importable without pulling the miner registry in, and avoids a
    # package-init cycle (repro_torch.mining's adapters import core.*).
    if name in _MINING_EXPORTS:
        import repro_torch.mining as _mining

        return getattr(_mining, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
