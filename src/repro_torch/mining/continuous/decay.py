"""Time-decayed supports over a ``SegmentedDB``: the damped-window model.

Each append is one *tick*. A segment appended at tick ``t`` contributes
its (exact, integer, device-computed) per-itemset supports scaled by
``decay ** (now - t)`` — newest batch weight 1, history fading
geometrically. The damping happens **only in the host-side cross-segment
reduce** (``LocalSegmentExecutor.collect`` with ``weights``): the packed
N-lists, the wave kernels, and the per-segment supports stay on the
exact integer path, and the float64 accumulation + post-reduce float
threshold are the only inexact steps. Segments are per-batch (decay
disables compaction — a merged segment has no single age), so the model
is exactly the classic damped window over batches.

``damped_oracle`` is the reference: a pure-host weighted Apriori over
the raw batches, used by the parity tests.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np

from repro_torch.core import encoding as enc


def segment_weights(segments, tick_now: int, decay: float) -> np.ndarray:
    """Per-segment damping factors ``decay ** (tick_now - seg.tick)``."""
    return np.array(
        [float(decay) ** (int(tick_now) - int(s.tick)) for s in segments],
        np.float64,
    )


def weighted_state(db, weights: np.ndarray):
    """The decayed global aggregates of a ``SegmentedDB``: weighted item
    counts over the stream rank space, the weighted F2 matrix, and the
    weighted row total (what ``min_sup`` resolves against). Mirrors
    ``register_batch`` / ``add_segment`` with each segment's integer
    contribution scaled by its weight."""
    items = np.asarray(db.order, np.int32)
    K = len(items)
    wsups = np.zeros(K, np.float64)
    wC = np.zeros((K, K), np.float64)
    wrows = 0.0
    for w, s in zip(weights, db.segments):
        wsups += w * s.hist(db.n_items)[items]
        gr = db.rank_of[s.local_items]
        wC[np.ix_(gr, gr)] += w * np.asarray(s.prepared.C, np.float64)
        wrows += w * s.n_rows
    return items, wsups, wC, wrows


def resolve_weighted(spec, wrows: float) -> float:
    """The float threshold of a decayed query: an absolute ``min_count``
    is used as-is; ``min_sup`` resolves against the *weighted* row total
    (no ceil — weighted supports are not integers). Floored at a tiny
    positive epsilon so an empty/exhausted window reports nothing rather
    than everything."""
    if spec.min_count is not None:
        return float(spec.min_count)
    if spec.min_sup is None:
        raise ValueError("MineSpec needs min_sup or min_count to mine")
    return max(float(spec.min_sup) * float(wrows), 1e-9)


def _row_sets(rows: np.ndarray) -> list:
    return [
        frozenset(int(i) for i in r if i != enc.PAD)
        for r in np.asarray(rows)
    ]


def damped_oracle(batches, n_items: int, decay: float, min_weight: float,
                  max_k: int | None = None) -> dict:
    """Reference damped-window mine: weighted Apriori straight off the
    raw batches (batch ``b`` of ``T`` weighted ``decay ** (T-1-b)``).
    Returns ``{itemset: weighted_support}`` for every itemset whose
    weighted support reaches ``min_weight``."""
    T = len(batches)
    sets_w = [(_row_sets(b_rows), float(decay) ** (T - 1 - b))
              for b, b_rows in enumerate(batches)]

    def wsup(fx: frozenset) -> float:
        return sum(
            w * sum(1 for r in rs if fx <= r) for rs, w in sets_w
        )

    out: dict[tuple, float] = {}
    f1 = []
    for i in range(n_items):
        s = wsup(frozenset((i,)))
        if s >= min_weight:
            out[(i,)] = s
            f1.append(i)
    prev = {frozenset((i,)) for i in f1}
    k = 2
    while prev and (max_k is None or k <= max_k):
        cur = set()
        for combo in combinations(f1, k):
            fx = frozenset(combo)
            if any(fx - {i} not in prev for i in fx):
                continue
            s = wsup(fx)
            if s >= min_weight:
                out[tuple(sorted(combo))] = s
                cur.add(fx)
        prev = cur
        k += 1
    return out
