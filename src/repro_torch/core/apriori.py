"""Vertical-bitmap Apriori baseline (beyond-paper comparator).

Candidate supports are AND + popcount over packed transaction bitmaps —
a vectorized stand-in for the classic Apriori family the paper groups its
related work into. Used in benchmarks to show where the N-list approach wins.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import encoding as enc

_POP = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int64)


def _popcount(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int64)
    return _POP[x]


def mine_apriori(rows: np.ndarray, n_items: int, min_count: int,
                 max_itemsets: int = 2_000_000, max_k: int | None = None):
    """Frequent itemsets via packed vertical bitmaps. Returns dict ids->sup."""
    supports = enc.item_support(rows, n_items)
    fl = enc.build_flist(supports, min_count)
    ranked = enc.rank_encode(rows, fl)
    R = len(ranked)
    K = fl.k
    out: dict[tuple[int, ...], int] = {}
    if K == 0:
        return out, {"peak_bytes": 0}

    # (K, ceil(R/8)) packed bitmap: bit r set iff row r contains rank k
    dense = np.zeros((K, R), np.uint8)
    r, c = np.nonzero(ranked != enc.PAD)
    dense[ranked[r, c], r] = 1
    bitmap = np.packbits(dense, axis=1)
    peak = bitmap.nbytes

    for k in range(K):
        out[(int(fl.items[k]),)] = int(fl.supports[k])

    # frontier: list of (ranks tuple, packed bitmap row)
    frontier = [((k,), bitmap[k]) for k in range(K)]
    while frontier and len(out) < max_itemsets:
        nxt = []
        for ranks, bits in frontier:
            base = ranks[0]
            if base == 0 or (max_k is not None and len(ranks) >= max_k):
                continue
            cand = bitmap[:base] & bits[None, :]
            sups = _popcount(cand).sum(axis=1)
            for q in np.flatnonzero(sups >= min_count):
                nr = (int(q),) + ranks
                ids = tuple(sorted(int(fl.items[x]) for x in nr))
                out[ids] = int(sups[q])
                nxt.append((nr, cand[q]))
        peak = max(peak, bitmap.nbytes + sum(b.nbytes for _, b in nxt))
        frontier = nxt
    return out, {"peak_bytes": peak + rows.nbytes}
