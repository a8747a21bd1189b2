"""Sort-based PPC-tree construction (the paper's Job-2 reduce, on the device).

The Hadoop reducer builds the PPC-tree by pointer insertion (``insert_tree``)
and then walks it twice to assign pre-/post-order ranks. Pointer tries do not
vectorize, so we construct the *identical* tree algebraically:

1. Lexicographically sort the rank-encoded transactions. In a prefix tree
   built from sorted rows, every trie node corresponds to a *distinct row
   prefix*, and the rows sharing that prefix are contiguous.
2. A node of depth ``d+1`` starts at row ``i`` iff column ``d`` is valid and
   the length-``d+1`` prefix differs from row ``i-1`` (vectorized cumulative
   OR of per-column inequality).
3. Flattening the boundary mask row-major enumerates nodes sorted by
   ``(start_row, depth)`` — which *is* pre-order (DFS of sorted rows).
4. ``subtree_size`` via ``searchsorted`` on the (non-decreasing) node start
   rows, and the closed form ``post = pre + size - 1 - depth`` replaces the
   post-order traversal.
5. ``count`` = windowed sum of row weights over the node's row range.

The result is bit-identical to the pointer-built tree (property-tested
against ``_build_ppc_pointer`` below) but is all sorts/scans/gathers — the
shape of computation an accelerator executes well; ``build_ppc_torch`` runs
it on the miner's device (one data shard owns its block's tree, exactly like
one Hadoop reducer).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.encoding import PAD


@dataclasses.dataclass
class PPCTree:
    """Flat PPC-tree: one row per node, pre-order sorted."""

    item: np.ndarray  # (N,) F-list rank registered by the node
    count: np.ndarray  # (N,) transactions through the node
    pre: np.ndarray  # (N,) pre-order rank == arange(N)
    post: np.ndarray  # (N,) post-order rank
    depth: np.ndarray  # (N,) 0-indexed depth (top-level nodes = 0)
    n_nodes: int

    def nlists(self, k: int) -> list[np.ndarray]:
        """Per-item N-lists: (len_i, 3) arrays of (pre, post, count), pre-asc.

        Nodes registering one item are an antichain (items are unique along
        any root path), so each list's pre-order intervals are disjoint —
        the property the vectorized intersection relies on.
        """
        order = np.argsort(self.item, kind="stable")  # stable keeps pre-order
        out: list[np.ndarray] = []
        bounds = np.searchsorted(self.item[order], np.arange(k + 1))
        packed = np.stack([self.pre, self.post, self.count], axis=1)
        for i in range(k):
            out.append(packed[order[bounds[i] : bounds[i + 1]]])
        return out


def build_ppc(rows: np.ndarray, weights: np.ndarray | None = None) -> PPCTree:
    """Host/numpy sort-based construction. ``rows`` rank-encoded, PAD=-1."""
    rows = np.asarray(rows, np.int32)
    R, L = rows.shape
    w = np.ones(R, np.int64) if weights is None else np.asarray(weights, np.int64)
    if R == 0:
        z = np.zeros(0, np.int64)
        return PPCTree(z, z, z, z, z, 0)

    order = np.lexsort(tuple(rows[:, c] for c in range(L - 1, -1, -1)))
    srows = rows[order]
    sw = w[order]

    valid = srows != PAD
    neq = np.ones_like(valid)
    neq[1:] = srows[1:] != srows[:-1]
    chg = np.logical_or.accumulate(neq, axis=1)  # prefix(d+1) differs from prev row
    newgrp = valid & chg

    # next row (strictly after i) where prefix of this depth changes
    idx = np.where(chg, np.arange(R)[:, None], R)
    nxt = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    nxt = np.vstack([nxt[1:], np.full((1, L), R, np.int64)])  # strict successor

    pos = np.flatnonzero(newgrp.ravel())  # row-major == (start_row, depth) == pre-order
    start = pos // L
    depth = pos % L
    end = nxt[start, depth]  # exclusive row end of the node's range

    wsum = np.concatenate([[0], np.cumsum(sw)])
    count = wsum[end] - wsum[start]
    item = srows[start, depth].astype(np.int64)

    n = len(pos)
    pre = np.arange(n, dtype=np.int64)
    size = np.searchsorted(start, end, side="left") - pre  # subtree is pre-order contiguous
    post = pre + size - 1 - depth
    return PPCTree(item=item, count=count, pre=pre, post=post, depth=depth.astype(np.int64), n_nodes=n)


def _lex_order(rows: torch.Tensor, n_items: int) -> torch.Tensor:
    """Stable lexicographic row order of ``rows`` (values in [-1, n_items)).

    torch has no ``lexsort``: columns are packed base-``n_items + 1`` into
    int64 keys (as many per key as fit in 62 bits; PAD -> 0 keeps its order)
    and the keys are stable-sorted from the least significant one up."""
    R, L = rows.shape
    base = n_items + 1
    per_key = 1
    while base ** (per_key + 1) < (1 << 62):
        per_key += 1
    order = torch.arange(R, device=rows.device)
    shifted = rows.to(torch.int64) + 1
    for c0 in reversed(range(0, L, per_key)):
        key = torch.zeros(R, dtype=torch.int64, device=rows.device)
        for c in range(c0, min(c0 + per_key, L)):
            key = key * base + shifted[:, c]
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def build_ppc_torch(rows: torch.Tensor, weights: torch.Tensor, n_items: int):
    """Device construction of the same tree as ``build_ppc``.

    ``rows`` rank-encoded (values in [-1, n_items)), ``weights`` (R,).
    Returns ``(item, count, pre, post)`` int64 over the tree's nodes in
    pre-order — only real nodes: eager torch sizes the node set with
    ``nonzero`` instead of padding it to a static ``max_nodes``.
    """
    R, L = rows.shape
    dev = rows.device
    order = _lex_order(rows, n_items)
    srows = rows[order]
    sw = weights.to(torch.int64)[order]

    valid = srows != PAD
    neq = torch.cat([torch.ones((1, L), dtype=torch.bool, device=dev), srows[1:] != srows[:-1]], dim=0)
    chg = torch.cumsum(neq, dim=1, dtype=torch.int32) > 0  # prefix(d+1) differs from prev row
    newgrp = valid & chg

    pos = torch.nonzero(newgrp.reshape(-1)).reshape(-1)  # row-major == pre-order
    start = pos // L
    depth = pos % L
    # exclusive end row of each node: the next row whose prefix of that depth
    # changes. Change positions in column-major order are sorted by (depth,
    # row), so that row is the next change position when it lies in the same
    # column (a lookup instead of a reverse cummin scan over the whole grid).
    cpos = torch.nonzero(chg.t().reshape(-1)).reshape(-1)
    nxt = torch.cat([cpos[1:], cpos.new_full((1,), L * R)])
    end_of = torch.where(nxt // R == cpos // R, nxt % R, R)
    end = end_of[torch.searchsorted(cpos, depth * R + start)]

    wsum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(sw, 0)])
    count = wsum[end] - wsum[start]
    item = srows[start, depth].to(torch.int64)
    pre = torch.arange(len(pos), device=dev)
    size = torch.searchsorted(start, end, side="left") - pre
    post = pre + size - 1 - depth
    return item, count, pre, post


# --------------------------------------------------------------------------
# Pointer-based oracle (the paper's literal insert_tree) — tests only.
# --------------------------------------------------------------------------


def _build_ppc_pointer(rows: np.ndarray, weights: np.ndarray | None = None) -> PPCTree:
    """Literal Algorithm-1 ``insert_tree`` + two traversals. O(R·L) pointers."""
    R, L = rows.shape
    w = np.ones(R, np.int64) if weights is None else np.asarray(weights, np.int64)
    root: dict = {"item": None, "count": 0, "children": {}}
    for r in range(R):
        node = root
        for c in range(L):
            it = int(rows[r, c])
            if it == PAD:
                break
            child = node["children"].get(it)
            if child is None:
                child = {"item": it, "count": 0, "children": {}}
                node["children"][it] = child
            child["count"] += int(w[r])
            node = child

    items, counts, pres, posts, depths = [], [], [], [], []
    pre_ctr = [0]
    post_ctr = [0]

    def visit(node, depth):
        my = len(items)
        items.append(node["item"])
        counts.append(node["count"])
        depths.append(depth)
        pres.append(pre_ctr[0])
        posts.append(-1)
        pre_ctr[0] += 1
        for it in sorted(node["children"]):  # children in item order == sorted-row DFS
            visit(node["children"][it], depth + 1)
        posts[my] = post_ctr[0]
        post_ctr[0] += 1

    for it in sorted(root["children"]):
        visit(root["children"][it], 0)
    return PPCTree(
        item=np.array(items, np.int64),
        count=np.array(counts, np.int64),
        pre=np.array(pres, np.int64),
        post=np.array(posts, np.int64),
        depth=np.array(depths, np.int64),
        n_nodes=len(items),
    )
