"""Derived pattern families over mined frequent itemsets.

The paper's lineage includes N-list miners for *closed* patterns (NAFCP,
ref [7]), subsume-enhanced mining (NSFI, ref [8]) and top-rank-k patterns
(NTK, ref [9]). Given the exact frequent-itemset dict our miners produce,
these families are clean post-passes — implemented here so the framework
exposes the same result surface as that literature:

  - closed:  no proper superset has the same support
  - maximal: no proper superset is frequent
  - top_rank_k: itemsets of the k highest distinct support values

All are property-tested against first-principles definitions.
"""
from __future__ import annotations

from collections import defaultdict


def closed_itemsets(itemsets: dict[tuple, int]) -> dict[tuple, int]:
    """Closed = no proper superset with equal support. O(n·k) via per-item
    inverted index rather than all-pairs."""
    by_item: dict[int, list[tuple]] = defaultdict(list)
    for s in itemsets:
        for i in s:
            by_item[i].append(s)
    out = {}
    for s, sup in itemsets.items():
        cands = by_item[s[0]] if s else list(itemsets)
        closed = True
        ss = set(s)
        for t in cands:
            if len(t) <= len(s) or itemsets[t] != sup:
                continue
            if ss.issubset(t):
                closed = False
                break
        if closed:
            out[s] = sup
    return out


def maximal_itemsets(itemsets: dict[tuple, int]) -> dict[tuple, int]:
    """Maximal = no proper frequent superset."""
    by_item: dict[int, list[tuple]] = defaultdict(list)
    for s in itemsets:
        for i in s:
            by_item[i].append(s)
    out = {}
    for s, sup in itemsets.items():
        cands = by_item[s[0]] if s else list(itemsets)
        ss = set(s)
        if not any(len(t) > len(s) and ss.issubset(t) for t in cands):
            out[s] = sup
    return out


def top_rank_k(itemsets: dict[tuple, int], k: int) -> dict[tuple, int]:
    """All itemsets whose support is among the k highest *distinct* support
    values (the NTK result surface)."""
    ranks = sorted({v for v in itemsets.values()}, reverse=True)[:k]
    keep = set(ranks)
    return {s: v for s, v in itemsets.items() if v in keep}
