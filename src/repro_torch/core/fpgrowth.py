"""FP-growth baseline (Han et al. 2000) — the paper's main comparator.

Classic recursive conditional-tree miner over a pointer FP-tree with header
links. Kept deliberately faithful to the original algorithm (host pointers,
recursion) so the runtime/memory comparison against the vectorized
PrePost/HPrepost path mirrors the paper's Figs 3-10 setup.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core import encoding as enc


class _Node:
    __slots__ = ("item", "count", "parent", "children", "link")

    def __init__(self, item, count, parent, children, link=None):
        self.item = item
        self.count = count
        self.parent = parent
        self.children = children
        self.link = link


class _FPTree:
    def __init__(self):
        self.root = _Node(-1, 0, None, {})
        self.header: dict[int, _Node] = {}
        self.n_nodes = 1

    def insert(self, path, count):
        node = self.root
        for it in path:
            child = node.children.get(it)
            if child is None:
                child = _Node(it, 0, node, {})
                node.children[it] = child
                child.link = self.header.get(it)
                self.header[it] = child
                self.n_nodes += 1
            child.count += count
            node = child


def _mine(tree: _FPTree, suffix: tuple, min_count: int, out: dict, item_sup: dict,
          stats: dict, max_itemsets: int, max_k: int | None = None):
    # items ascending support so conditional trees stay small
    for it in sorted(item_sup, key=lambda i: item_sup[i]):
        if len(out) >= max_itemsets:
            return
        newset = (it,) + suffix
        out[newset] = item_sup[it]
        if max_k is not None and len(newset) >= max_k:
            continue
        # build conditional pattern base
        cond = _FPTree()
        cond_sup: dict[int, int] = {}
        node = tree.header.get(it)
        paths = []
        while node is not None:
            path = []
            p = node.parent
            while p is not None and p.item != -1:
                path.append(p.item)
                p = p.parent
            path.reverse()
            if path:
                paths.append((path, node.count))
                for x in path:
                    cond_sup[x] = cond_sup.get(x, 0) + node.count
            node = node.link
        cond_sup = {x: s for x, s in cond_sup.items() if s >= min_count}
        for path, cnt in paths:
            fpath = [x for x in path if x in cond_sup]
            if fpath:
                cond.insert(fpath, cnt)
        stats["peak_nodes"] = max(stats["peak_nodes"], stats["live_nodes"] + cond.n_nodes)
        stats["live_nodes"] += cond.n_nodes
        if cond_sup:
            _mine(cond, newset, min_count, out, cond_sup, stats, max_itemsets, max_k)
        stats["live_nodes"] -= cond.n_nodes


def mine_fpgrowth(rows: np.ndarray, n_items: int, min_count: int,
                  max_itemsets: int = 2_000_000, max_k: int | None = None):
    """Returns (itemsets dict in original ids, stats with peak node estimate)."""
    supports = enc.item_support(rows, n_items)
    fl = enc.build_flist(supports, min_count)
    ranked = enc.rank_encode(rows, fl)
    urows, w = enc.dedup_rows(ranked)

    tree = _FPTree()
    for r in range(len(urows)):
        path = [int(x) for x in urows[r] if x != enc.PAD]
        if path:
            tree.insert(path, int(w[r]))

    item_sup = {int(r): int(fl.supports[r]) for r in range(fl.k)}
    out_ranks: dict[tuple, int] = {}
    stats = {"live_nodes": tree.n_nodes, "peak_nodes": tree.n_nodes}
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        _mine(tree, (), min_count, out_ranks, item_sup, stats, max_itemsets, max_k)
    finally:
        sys.setrecursionlimit(old_limit)

    out = {
        tuple(sorted(int(fl.items[r]) for r in ranks)): sup
        for ranks, sup in out_ranks.items()
    }
    # rough per-node footprint of the pointer tree (paper measures JVM heap)
    stats["peak_bytes"] = stats["peak_nodes"] * 120 + urows.nbytes
    return out, stats
