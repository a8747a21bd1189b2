"""N-list structure and vectorized intersection (the paper's §3.2 / Example 2).

An N-list is the sequence of PP-codes ``({pre, post}: count)`` of the nodes
registering an item, pre-order ascending. The paper intersects two N-lists by
a linear merge with the ancestor test ``x.pre < y.pre and x.post > y.post``.

Data-parallel form: all nodes registering one item form an **antichain** (no two
are on the same root path, since items are unique along a path), so their
subtree intervals are disjoint in pre-order. Hence code ``y`` has *at most
one* ancestor in list ``A``, and it can only be ``A[searchsorted(A.pre,
y.pre) - 1]`` — the linear merge becomes a data-parallel gather:

    idx   = searchsorted(A.pre, y.pre) - 1        # candidate ancestor
    hit   = idx >= 0  and  A.post[idx] > y.post   # subsume test
    out   = segment_sum(y.count * hit, idx, La)   # merged counts on A's codes
    sup   = out.sum()

This is O(|Y| log |A|) independent parallel lanes instead of a sequential
merge — the form the CUDA kernel (kernels/nlist_intersect) implements with
the A list resident in shared memory.

The merged N-list of ``P ∪ {q}`` always lives on ``q``'s code slots, so an
itemset's N-list is represented as *(base item q, counts aligned with
NL(q))* — static shapes, so a whole wave of candidates is one batched launch.
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.iinfo(np.int32).max


def intersect_np(
    a_pre: np.ndarray,
    a_post: np.ndarray,
    y_pre: np.ndarray,
    y_post: np.ndarray,
    y_cnt: np.ndarray,
) -> np.ndarray:
    """Counts of the merged N-list, aligned with A's codes. Host path."""
    la = len(a_pre)
    if la == 0 or len(y_pre) == 0:
        return np.zeros(la, np.int64)
    idx = np.searchsorted(a_pre, y_pre, side="left") - 1
    ok = (idx >= 0) & (a_post[np.clip(idx, 0, la - 1)] > y_post)
    return np.bincount(idx[ok], weights=y_cnt[ok].astype(np.float64), minlength=la).astype(np.int64)


def intersect_torch(a_pre, a_post, y_pre, y_post, y_cnt):
    """Intersection on padded int32 buffers, on any device; a leading
    candidate axis batches it (``searchsorted`` takes batched rows).

    The padding contract: a slot whose pre is ``INF`` is padding, a suffix
    of each list. Whatever post and count it carries, a padding Y code
    merges into no A slot (it is masked), and no valid Y code reaches an A
    padding slot (it sorts last). The wave kernels B1/B2 keep the same
    contract. The reference's ``intersect_jnp`` gives a padding code's count
    to the last valid A code and its Pallas kernel to every valid A code;
    all three agree where padding counts are 0, as every miner path writes
    them (``pre = INF, post = -1, cnt = 0``).
    """
    la = a_pre.shape[-1]
    idx = torch.searchsorted(a_pre.contiguous(), y_pre.contiguous(), side="left") - 1
    cidx = idx.clamp(0, max(la - 1, 0))
    ok = (idx >= 0) & (y_pre != INF) & (torch.gather(a_post, -1, cidx) > y_post)
    contrib = torch.where(ok, y_cnt, 0).to(torch.int64)
    out = torch.zeros(a_pre.shape, dtype=torch.int64, device=a_pre.device)
    return out.scatter_add_(-1, cidx, contrib)


def pad_nlist(nl: np.ndarray, width: int) -> np.ndarray:
    """(n,3) (pre,post,cnt) -> (width,3) with INF/-1/0 padding."""
    out = np.empty((width, 3), np.int64)
    out[:, 0] = INF
    out[:, 1] = -1
    out[:, 2] = 0
    n = min(len(nl), width)
    out[:n] = nl[:n]
    return out


def pack_nlists(nlists: list[np.ndarray], width: int | None = None) -> np.ndarray:
    """Stack per-item N-lists into (K, width, 3) with padding (device-ready)."""
    width = width or max((len(x) for x in nlists), default=1)
    width = max(width, 1)
    return np.stack([pad_nlist(x, width) for x in nlists])
