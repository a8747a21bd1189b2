"""Single-shard PrePost / PrePost+ miner (the paper's §3.3 baseline).

Set-enumeration DFS over F-list ranks. An itemset ``P = {p1 < ... < pk}``
(rank ascending) is extended with items ``q < p1``; its N-list lives on the
codes of its minimum-rank item (see nlist.py). Steps mirror the paper:
(1) support count -> F-list; (2) rank-encode + PPC-tree; (3) F2 from the
co-occurrence matrix (equals the paper's step-3 tree scan); (4) k>2 by
N-list intersection.

``cpe=True`` enables PrePost+'s Children-Parent-Equivalence pruning
(Deng & Lv 2015, paper ref [21]): if ``support(P ∪ {q}) == support(P)``,
every transaction holding ``P`` also holds ``q``, so ``q``'s whole branch
mirrors ``P``'s. We then (a) ban ``q`` from the subtree, (b) multiply the
subtree's itemset *multiplicity* by 2 — each explicit itemset ``S`` below
``P`` stands for ``S ∪ Q`` for every subset ``Q`` of the accumulated
equivalent items, all with ``support(S)``. ``total_count`` is exact
(property-tested equal to the cpe=False enumeration).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import encoding as enc
from repro_torch.core import nlist as nl
from repro_torch.core.ppc import build_ppc


@dataclasses.dataclass
class PrepostResult:
    """Low-level miner output (original item ids). The public surface is
    the enriched ``repro.mining.MineResult``; adapters build it from this."""

    itemsets: dict[tuple[int, ...], int]  # explicitly mined itemsets -> support
    flist_items: np.ndarray
    n_explicit: int
    total_count: int  # exact number of frequent itemsets (incl. CPE-implied)
    peak_bytes: int  # analytic peak of mining structures (paper's memory figs)

    def support_of(self, itemset) -> int:
        return self.itemsets[tuple(sorted(int(i) for i in itemset))]


def cooccurrence(rows: np.ndarray, weights: np.ndarray, k: int, block: int = 8192) -> np.ndarray:
    """Weighted pair co-occurrence ``C[i, j]`` (i < j) over rank-encoded rows.

    ``C = Xᵀ diag(w) X`` on the one-hot row matrix — the matrix form of the
    paper's F2 tree scan (kernels/cooccur computes it on the device).
    """
    C = np.zeros((k, k), np.float64)
    for s in range(0, len(rows), block):
        chunk = rows[s : s + block]
        w = weights[s : s + block]
        X = np.zeros((len(chunk), k), np.float64)
        r, c = np.nonzero(chunk != enc.PAD)
        X[r, chunk[r, c]] = 1.0
        C += (X * w[:, None]).T @ X
    return np.triu(C, 1).astype(np.int64)


def mine_prepost(
    rows: np.ndarray,
    n_items: int,
    min_count: int,
    *,
    cpe: bool = False,
    max_k: int | None = None,
    max_itemsets: int = 2_000_000,
) -> PrepostResult:
    """Mine all frequent itemsets from a padded (R, L) transaction matrix."""
    supports = enc.item_support(rows, n_items)
    fl = enc.build_flist(supports, min_count)
    ranked = enc.rank_encode(rows, fl)
    urows, w = enc.dedup_rows(ranked)
    tree = build_ppc(urows, w)
    nlists = tree.nlists(fl.k)
    K = fl.k

    static_bytes = tree.n_nodes * 5 * 8 + sum(x.nbytes for x in nlists) + urows.nbytes
    peak = static_bytes
    itemsets: dict[tuple[int, ...], int] = {}
    total = 0

    def emit(ranks: tuple[int, ...], sup: int, m: int):
        nonlocal total
        ids = tuple(sorted(int(fl.items[r]) for r in ranks))
        itemsets[ids] = int(sup)
        total += m

    if K == 0:
        return PrepostResult(itemsets, fl.items, 0, 0, peak)

    C = cooccurrence(urows, w, K) if K > 1 and max_k != 1 else np.zeros((K, K), np.int64)
    peak += C.nbytes
    pair_ok = (C + C.T) >= min_count

    # DFS stack entries: (ranks, codes (n,3) on min-rank item, banned, mult, bytes_on_stack)
    stack: list[tuple[tuple[int, ...], np.ndarray, frozenset, int]] = []
    for p in range(K):
        emit((p,), int(fl.supports[p]), 1)
        if max_k != 1:
            stack.append(((p,), nlists[p], frozenset(), 1))

    stack_bytes = sum(c.nbytes for _, c, _, _ in stack)
    peak = max(peak, static_bytes + C.nbytes + stack_bytes)

    while stack and len(itemsets) < max_itemsets:
        ranks, codes, banned, mult = stack.pop()
        stack_bytes -= codes.nbytes
        base = ranks[0]
        if max_k is not None and len(ranks) >= max_k:
            continue
        psup = int(codes[:, 2].sum())
        eq: list[int] = []
        children: list[tuple[tuple[int, ...], np.ndarray]] = []
        for q in range(base - 1, -1, -1):
            if q in banned or not all(pair_ok[q, p] for p in ranks):
                continue
            counts = nl.intersect_np(
                nlists[q][:, 0], nlists[q][:, 1], codes[:, 0], codes[:, 1], codes[:, 2]
            )
            sup = int(counts.sum())
            if sup < min_count:
                continue
            if cpe and sup == psup:
                eq.append(q)
                emit((q,) + ranks, sup, 0)  # visibility only; counted via factor
                continue
            keep = counts > 0
            new_codes = np.column_stack([nlists[q][keep][:, :2], counts[keep]])
            children.append(((q,) + ranks, new_codes))
        factor = 1 << len(eq)
        if eq:
            total += mult * (factor - 1)  # implied copies of P itself
        child_banned = banned | frozenset(eq) if eq else banned
        child_mult = mult * factor
        for cranks, ccodes in children:
            emit(cranks, int(ccodes[:, 2].sum()), child_mult)
            stack.append((cranks, ccodes, child_banned, child_mult))
            stack_bytes += ccodes.nbytes
        peak = max(peak, static_bytes + C.nbytes + stack_bytes)

    return PrepostResult(itemsets, fl.items, len(itemsets), total, peak)
