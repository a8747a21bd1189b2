"""Transaction encoding for N-list mining.

The paper's Job-1/Job-2 "map" side: item support counting, F-list construction
(frequent 1-itemsets sorted by descending support) and re-encoding of every
transaction into dense F-list *ranks* (0 = most frequent item), filtered of
infrequent items and sorted in F-list order.

Transactions are held as a padded int32 matrix ``(n_rows, max_len)`` with
``PAD = -1``. Both a numpy host path (reference, used by the single-shard
miner) and a torch path (run on the miner's device by HPrepost) are
provided; they are tested against each other.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

PAD = -1
# Sentinel used while sorting ranks inside a row; larger than any valid rank.
_BIG = np.iinfo(np.int32).max // 2


def pad_transactions(tx: Sequence[Sequence[int]], max_len: int | None = None) -> np.ndarray:
    """Pack ragged transactions into a ``(R, L)`` int32 matrix, PAD = -1.

    Duplicate items within a transaction are dropped (itemsets are sets).
    Transactions longer than ``max_len`` are truncated (documented surrogate
    behaviour for heavy-tail datasets).
    """
    dedup = [sorted(set(int(i) for i in t)) for t in tx]
    L = max_len or max((len(t) for t in dedup), default=1)
    L = max(L, 1)
    out = np.full((len(dedup), L), PAD, dtype=np.int32)
    for r, t in enumerate(dedup):
        t = t[:L]
        out[r, : len(t)] = t
    return out


def item_support(rows: np.ndarray, n_items: int, weights: np.ndarray | None = None) -> np.ndarray:
    """Job-1 word count (host path): support of every item id."""
    flat = rows.ravel()
    mask = flat != PAD
    if weights is None:
        return np.bincount(flat[mask], minlength=n_items).astype(np.int64)
    w = np.broadcast_to(weights[:, None], rows.shape).ravel()
    return np.bincount(flat[mask], weights=w[mask], minlength=n_items).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class FList:
    """Frequent-1-itemset list: original item ids sorted by descending support."""

    items: np.ndarray  # (K,) original item ids, support-descending
    supports: np.ndarray  # (K,) support of each, aligned with items
    n_items: int  # size of the original item universe
    min_count: int

    @property
    def k(self) -> int:
        return len(self.items)

    def rank_lut(self) -> np.ndarray:
        """item id -> F-list rank; infrequent items map to _BIG."""
        lut = np.full(self.n_items + 1, _BIG, dtype=np.int32)
        lut[self.items] = np.arange(self.k, dtype=np.int32)
        return lut


def build_flist(supports: np.ndarray, min_count: int) -> FList:
    """Keep items with support >= min_count, sort descending (ties: item asc)."""
    supports = np.asarray(supports, np.int64)
    n_items = len(supports)
    keep = np.flatnonzero(supports >= min_count)
    # stable sort on -support -> ties broken by item id ascending
    order = keep[np.argsort(-supports[keep], kind="stable")]
    return FList(
        items=order.astype(np.int32),
        supports=supports[order],
        n_items=n_items,
        min_count=int(min_count),
    )


def rank_encode(rows: np.ndarray, flist: FList) -> np.ndarray:
    """Job-2 map (host path): re-encode rows to ranks, drop infrequent, sort.

    Output rows hold F-list ranks ascending (most frequent first), PAD = -1.
    """
    lut = flist.rank_lut()
    ranked = np.where(rows == PAD, _BIG, lut[np.clip(rows, 0, flist.n_items)])
    ranked.sort(axis=1)
    return np.where(ranked >= _BIG, PAD, ranked).astype(np.int32)


def rank_encode_torch(rows: torch.Tensor, rank_lut: torch.Tensor, n_items: int) -> torch.Tensor:
    """Job-2 map on the rows' device. ``rank_lut`` from ``FList.rank_lut()``,
    on the same device as ``rows``."""
    ranked = torch.where(rows == PAD, _BIG, rank_lut[rows.clamp(0, n_items).long()])
    ranked = torch.sort(ranked, dim=1).values
    return torch.where(ranked >= _BIG, PAD, ranked).to(torch.int32)


def dedup_rows(rows: np.ndarray, weights: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Merge identical (ranked) transactions into (unique_rows, weights).

    The PPC-tree does this implicitly (shared paths); doing it eagerly keeps
    every later sort/scan proportional to *distinct* paths, which is the same
    compression the paper's tree achieves.
    """
    w = np.ones(len(rows), np.int64) if weights is None else np.asarray(weights, np.int64)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    wsum = np.bincount(inv, weights=w, minlength=len(uniq)).astype(np.int64)
    # drop the all-PAD row (empty transaction) if present
    nonempty = ~(uniq == PAD).all(axis=1)
    return uniq[nonempty], wsum[nonempty]
