"""Brute-force frequent-itemset oracle for tests (small DBs only)."""
from __future__ import annotations

from itertools import combinations

import numpy as np

from repro_torch.core.encoding import PAD


def support_of(rows: np.ndarray, itemset, weights=None) -> int:
    """Exact support of one itemset by scanning every transaction."""
    w = np.ones(len(rows), np.int64) if weights is None else np.asarray(weights)
    mask = np.ones(len(rows), bool)
    for it in itemset:
        mask &= (rows == it).any(axis=1)
    return int(w[mask].sum())


def mine_bruteforce(rows: np.ndarray, n_items: int, min_count: int, max_k: int | None = None):
    """All frequent itemsets by Apriori-style BFS over explicit candidates."""
    present = [np.flatnonzero([support_of(rows, (i,)) >= min_count for i in range(n_items)])]
    f1 = [int(i) for i in present[0]]
    out: dict[tuple[int, ...], int] = {(i,): support_of(rows, (i,)) for i in f1}
    prev = [(i,) for i in f1]
    k = 2
    while prev and (max_k is None or k <= max_k):
        cur = []
        cand = set()
        for base in prev:
            for i in f1:
                if i > base[-1]:
                    cand.add(base + (i,))
        for c in sorted(cand):
            if any(tuple(s) not in out for s in combinations(c, len(c) - 1)):
                continue
            sup = support_of(rows, c)
            if sup >= min_count:
                out[c] = sup
                cur.append(c)
        prev = cur
        k += 1
    return out
